"""``sequence/tiling.py`` and the model's tiled loss against the reference
on the CPU (fp32): ``sequence_tiled_compute`` and ``TiledMLP`` outputs and
input gradients agree to 1e-6 relative; ``tiled_logits_loss`` with
``z_loss`` and negative labels (-100 and -1) to 1e-6 in value and 1e-5 in
its gradients, and equals the dense loss over the same labels; the
``tiny`` model with ``loss_tiling`` 4 (2 layers, width 64) matches the
reference's tiled loss and the port's dense loss, with and without an
attention mask, gradients to 1e-5 relative L2."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models import get_preset as jax_preset
from deepspeed_tpu.sequence import tiling as jt
from deepspeed_tpu_torch.bridge import params_from_numpy
from deepspeed_tpu_torch.models import TransformerLM, get_preset
from deepspeed_tpu_torch.models.spec import tree_leaves
from deepspeed_tpu_torch.sequence import (TiledMLP, sequence_tiled_compute,
                                          tiled_logits_loss)
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_model import perturbed_params

rng = np.random.default_rng(7)
X = rng.standard_normal((2, 12, 8)).astype(np.float32)
W = rng.standard_normal((8, 8)).astype(np.float32)
H = rng.standard_normal((2, 16, 8)).astype(np.float32)
HEAD = rng.standard_normal((8, 32)).astype(np.float32)
LABELS = rng.integers(0, 32, (2, 16)).astype(np.int32)
LABELS[0, 3], LABELS[1, 7], LABELS[1, 15] = -100, -1, -100


def _t(a):
    return torch.from_numpy(np.array(a)).requires_grad_(
        np.asarray(a).dtype == np.float32)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("shards", [1, 3, 4, 5])
def test_sequence_tiled_compute_and_tiled_mlp(shards):
    def jfn(c, w):
        return jnp.tanh(c @ w)

    def tfn(c, w):
        return torch.tanh(c @ w)

    want, jvjp = jax.vjp(lambda x: jt.sequence_tiled_compute(
        lambda c: jfn(c, W), x, shards), X)
    x = _t(X)
    got = sequence_tiled_compute(lambda c: tfn(c, torch.from_numpy(W)), x,
                                 shards)
    assert _rel(got.detach(), want) <= 1e-6
    got.sum().backward()
    assert _rel(x.grad, jvjp(jnp.ones_like(want))[0]) <= 1e-6
    mlp = TiledMLP(tfn, num_shards=shards)(torch.from_numpy(X),
                                           torch.from_numpy(W))
    assert _rel(mlp, jt.TiledMLP(jfn, num_shards=shards)(X, W)) <= 1e-6


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
@pytest.mark.parametrize("shards", [1, 4, 8])
def test_tiled_logits_loss(shards, z_loss):
    want, (jdh, jdw) = jax.value_and_grad(
        lambda h, w: jt.tiled_logits_loss(h, w, LABELS, num_shards=shards,
                                          z_loss=z_loss), argnums=(0, 1))(
        H, HEAD)
    h, w = _t(H), _t(HEAD)
    got = tiled_logits_loss(h, w, torch.from_numpy(LABELS),
                            num_shards=shards, z_loss=z_loss)
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    got.backward()
    assert _rel(h.grad, jdh) <= 1e-5 and _rel(w.grad, jdw) <= 1e-5
    # the dense loss over the same labels (every negative one masked)
    logits = torch.from_numpy(H) @ torch.from_numpy(HEAD)
    logz = torch.logsumexp(logits, -1)
    lab = torch.from_numpy(LABELS).long()
    nll = logz - logits.gather(-1, lab.clamp_min(0)[..., None])[..., 0]
    nll = nll + z_loss * logz.square()
    dense = torch.where(lab >= 0, nll, 0.0).sum() / (lab >= 0).sum()
    assert abs(float(got) - float(dense)) <= 1e-5 * abs(float(dense))


@pytest.fixture(scope="module")
def tiny():
    jm = JaxLM(jax_preset("tiny", dtype="float32", loss_tiling=4,
                          z_loss=1e-3))
    params = perturbed_params(jm, seed=5)
    ids = np.random.default_rng(6).integers(0, 256, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 10:] = 0
    return jm, params, ids, mask


def _names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _names(tree[k],
                                                        f"{prefix}{k}.")]
    return [prefix[:-1]]


@pytest.mark.parametrize("masked", [False, True])
def test_model_loss_tiling_against_reference_and_dense(tiny, masked):
    jm, params, ids, mask = tiny
    batch = {"input_ids": ids, **({"attention_mask": mask} if masked
                                  else {})}
    want, jg = jax.value_and_grad(lambda p: jm.loss_fn(p, batch))(params)
    jg = dict(zip(_names(jg), jax.tree_util.tree_leaves(jg)))
    cfg = get_preset("tiny", dtype="float32", loss_tiling=4, z_loss=1e-3)
    results = []
    for c in (cfg, dataclasses.replace(cfg, loss_tiling=0)):
        p = params_from_numpy(params, device="cpu")
        leaves = list(tree_leaves(p))
        for t in leaves:
            t.requires_grad_(True)
        loss = TransformerLM(c).loss_fn(
            p, {k: torch.from_numpy(v) for k, v in batch.items()})
        results.append((float(loss), dict(zip(
            _names(p), torch.autograd.grad(loss, leaves)))))
    (tiled, tg), (dense, dg) = results
    assert abs(tiled - float(want)) <= 1e-5 * abs(float(want))
    assert abs(tiled - dense) <= 1e-5 * abs(dense)
    for name, w in jg.items():
        assert _rel(tg[name], w) <= 1e-5, name
        assert _rel(tg[name], dg[name]) <= 1e-5, name
