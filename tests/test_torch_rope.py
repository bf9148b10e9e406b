"""Positions past the rotary table, against the JAX package on the CPU.

The reference's gather clamps an index past the table to its last row
(``deepspeed_tpu/models/transformer.py`` ``apply_rope``); the port clamps
the same way (on the card an unclamped index would be a device-side
assert that poisons the process's CUDA context, every replica of a fleet
included). The ``tiny`` preset's table is 64 positions; its serving tests
run engines of ``max_seq_len`` 128.
"""

import jax
import numpy as np
import torch

from tests._torch_threads import one_torch_thread  # noqa: F401

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)      # engines (test_torch_engine.py)


def test_apply_rope_clamps_like_the_reference():
    from deepspeed_tpu.models import transformer as jt
    from deepspeed_tpu_torch.models import transformer as tt

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = np.array([[0, 63, 64, 90, 127], [1, 2, 65, 66, 200]], np.int32)
    jf = jt.rope_frequencies(16, 64, 10000.0)
    tf = tt.rope_frequencies(16, 64, 10000.0)
    np.testing.assert_allclose(np.asarray(tf), np.asarray(jf), rtol=1e-6)
    want = np.asarray(jt.apply_rope(jax.numpy.asarray(x), jf,
                                    jax.numpy.asarray(pos)))
    got = tt.apply_rope(torch.from_numpy(x), tf, torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    # past the table is the last row, not a wrap-around or an error
    last = tt.apply_rope(torch.from_numpy(x), tf, torch.full((2, 5), 63))
    np.testing.assert_array_equal(got[:, 3].numpy(), last[:, 3].numpy())


def test_engine_decodes_past_the_rotary_table_like_the_reference():
    """A 60-token prompt on engines of ``max_seq_len`` 128 over the
    ``tiny`` preset (table 64), then 8 greedy single-token puts through
    positions 60-67: every logits row matches the reference's."""
    from deepspeed_tpu.inference import InferenceEngineV2 as JaxEngine
    from deepspeed_tpu.models import TransformerLM as JaxLM
    from deepspeed_tpu.models import get_preset as jax_preset
    from deepspeed_tpu_torch.bridge import params_from_numpy
    from deepspeed_tpu_torch.inference import InferenceEngineV2
    from deepspeed_tpu_torch.models import TransformerLM, get_preset

    kw = dict(max_sequences=2, max_seq_len=128, block_size=16)
    jm = JaxLM(jax_preset("tiny", dtype="float32"))
    assert jm.cfg.max_seq_len == 64
    params = jax.device_get(jm.init(jax.random.key(0)))
    jeng = JaxEngine(jm, params=params, decode_kernel="xla", **kw)
    teng = InferenceEngineV2(TransformerLM(get_preset("tiny",
                                                      dtype="float32")),
                             params_from_numpy(params, device="cpu"),
                             device="cpu", **kw)
    prompt = np.random.default_rng(1).integers(1, 256, 60).astype(np.int32)
    feeds = {"jax": prompt, "torch": prompt}
    for step in range(9):
        want = np.asarray(jeng.put([0], [feeds["jax"]])[0], np.float32)
        got = teng.put([0], [feeds["torch"]])[0]
        np.testing.assert_allclose(got, want, **LOGIT_TOL,
                                   err_msg=f"step {step}")
        tok = np.array([int(np.argmax(want))], np.int32)
        feeds = {"jax": tok, "torch": tok}
    assert teng.state.sequences[0].seen_tokens == 68
