"""Fused dequant-matmul of the PyTorch port (kernels G/H' plain version and
the shape rule) against the JAX package on the CPU, from numpy-seeded fp32
inputs.

* ``quantize_matmul_weight`` gives bit-identical packed bytes and scales,
  int8 and int4, to the reference as its engine runs it, under ``jax.jit``
  (XLA turns ``amax / qmax`` into a product with the reciprocal, which
  differs from op-by-op JAX in the last bit of some scales), and
  ``dequantize_matmul_weight`` the same bf16 weights;
* the plain G/H match the JAX ``quantized_matmul`` in Pallas interpret mode,
  ``layer=`` on a stack included, at D = F = 256 and B in {1, 8, 256}, to
  atol = rtol = 1e-5 (fp32 sums in another order);
* off the shape rule (B > 256, D or F not a multiple of 128) both compute
  ``x @ dequantize(...)`` on bf16-rounded weights: the same to 1e-5.

The random weights give every byte's two int4 nibbles different values in
most bytes (checked), so a kernel or unpack that swapped the in-group
de-interleave for the KV pool's global pairing would fail here.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import quant_matmul as jqm
from deepspeed_tpu_torch.ops import quant_matmul as tqm
from deepspeed_tpu_torch.ops._build import KERNELS

TOL = dict(atol=1e-5, rtol=1e-5)
ROOT = Path(__file__).resolve().parent.parent


def _w(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("D,F,group", [(256, 256, 128), (512, 384, 256),
                                       (128, 128, 128)])
def test_quantize_is_bit_identical(bits, D, F, group):
    w = _w((D, F), D + F + bits)
    w[3, 5] = 0.0                                  # exact zeros and ties
    w[7] = 0.0
    pj, sj = jax.jit(jqm.quantize_matmul_weight, static_argnums=(1, 2))(
        jnp.asarray(w), bits, group)
    pt, st = tqm.quantize_matmul_weight(torch.from_numpy(w), bits=bits,
                                        group=group)
    assert pt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    dj = np.asarray(jqm.dequantize_matmul_weight(pj, sj, bits, D)
                    .astype(jnp.float32))
    dt = tqm.dequantize_matmul_weight(pt, st, bits, D).float().numpy()
    np.testing.assert_array_equal(dt, dj)


def test_int4_nibbles_differ():
    """The test weights exercise both halves of the in-group layout."""
    p, _ = tqm.quantize_matmul_weight(torch.from_numpy(_w((256, 256), 0)),
                                      bits=4)
    b = p.to(torch.int32)
    lo, hi = (b << 28) >> 28, b >> 4
    assert float((lo != hi).float().mean()) > 0.8


def _stack(L, D, F, bits, seed):
    ps, ss = [], []
    for i in range(L):
        p, s = tqm.quantize_matmul_weight(
            torch.from_numpy(_w((D, F), seed + i)), bits=bits)
        ps.append(p)
        ss.append(s)
    return torch.stack(ps), torch.stack(ss)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("B", [1, 8, 256])
@pytest.mark.parametrize("layer", [None, 2])
def test_plain_g_h_match_pallas_interpret(bits, B, layer):
    D = F = 256
    packed, scales = _stack(3, D, F, bits, seed=10 * bits + B)
    x = _w((B, D), B)
    if layer is None:
        packed, scales = packed[1], scales[1]
    want = jqm.quantized_matmul(jnp.asarray(x), jnp.asarray(packed.numpy()),
                                jnp.asarray(scales.numpy()), bits=bits,
                                interpret=True,
                                layer=None if layer is None
                                else jnp.int32(layer))
    assert tqm.uses_kernel(torch.from_numpy(x), scales)
    n = {k: KERNELS[k].launches for k in ("qmm", "qmm_stacked")}
    got = tqm.quantized_matmul(torch.from_numpy(x), packed, scales, bits=bits,
                               layer=layer)
    assert {k: KERNELS[k].launches for k in n} == n      # CPU: no kernel
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = tqm.plain_quantized_matmul(torch.from_numpy(x), packed, scales,
                                       bits, layer)
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("B,D,F", [(257, 256, 256), (4, 192, 256),
                                   (4, 256, 192)])
def test_off_shape_rule_uses_the_dense_product(bits, B, D, F):
    group = 64 if D % 128 else 128
    p, s = tqm.quantize_matmul_weight(torch.from_numpy(_w((D, F), D)),
                                      bits=bits, group=group)
    x = _w((B, D), B + D)
    assert not tqm.uses_kernel(torch.from_numpy(x), s)
    want = jqm.quantized_matmul(jnp.asarray(x), jnp.asarray(p.numpy()),
                                jnp.asarray(s.numpy()), bits=bits,
                                interpret=True)
    got = tqm.quantized_matmul(torch.from_numpy(x), p, s, bits=bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    dense = torch.from_numpy(x) @ tqm.dequantize_matmul_weight(
        p, s, bits, D).float()
    np.testing.assert_array_equal(got.numpy(), dense.numpy())


def test_kernel_args_refuse_a_mismatched_stack():
    """The launcher arguments are checked before any launch: a packed stack
    of the wrong width, or a layer outside the stack, raises."""
    packed, scales = _stack(2, 256, 256, 4, seed=3)
    x = torch.zeros(4, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="does not match int8"):
        tqm.qmm_kernel_args(x, packed, scales.bfloat16(), 8, layer=0)
    with pytest.raises(IndexError, match="outside a stack"):
        tqm.qmm_kernel_args(x, packed, scales.bfloat16(), 4, layer=2)


@pytest.mark.parametrize("B,F,G,want", [
    # the decode kernel (B <= 16): at most one wave of two 128-column CTAs
    # an SM, a multiple of RWARPS groups a split -- the head (1002 CTAs)
    # and w_gateup (224) unsplit, wqkv (48) in 4 (8 groups each), wo (32)
    # in 8 (4 each), w_down's 112 groups in 7 (16 each)
    (6, 128256, 32, 1), (6, 4096, 32, 8), (6, 4096, 112, 7),
    (6, 28672, 32, 1), (256, 28672, 32, 1), (8, 6144, 32, 4),
    (17, 384, 2, 2),
    # the 128 x 128 tile kernel at B=256: wo and w_down (64 CTAs) split in
    # two, wqkv (96) and w_gateup (448) fill a wave already
    (256, 4096, 32, 2), (256, 4096, 112, 2), (256, 6144, 32, 1),
    (128, 4096, 32, 4), (129, 6144, 32, 1), (64, 6144, 32, 2)])
def test_splits_fill_the_card_and_cover_every_group(B, F, G, want):
    splits = tqm.qmm_splits(B, F, G)
    assert splits == want
    per = -(-G // splits)
    assert (splits - 1) * per < G <= splits * per
    if B > 16:          # one CTA an SM: the grid stays within one wave
        ctas = (F // tqm._TN) * -(-B // tqm._TM)
        assert splits == 1 or ctas * splits <= tqm._SMS
    else:               # a split's groups share evenly over the warps
        assert splits == 1 or per % tqm._RWARPS == 0


@pytest.mark.parametrize("B", [1, 6, 16])
@pytest.mark.parametrize("F", [128, 384, 4096, 6144, 28672, 128256])
@pytest.mark.parametrize("G", [1, 2, 8, 32, 112])
def test_decode_splits_are_one_wave_at_most(B, F, G):
    """At B <= 16 the split count is a pure function of (B, F, G) that
    covers every group with no empty split, gives every warp of a CTA the
    same number of groups whenever it splits, and stays within one wave of
    the decode kernel's CTAs (two an SM); no split count with those
    properties is larger."""
    splits = tqm.qmm_splits(B, F, G)
    per = -(-G // splits)
    assert 1 <= splits <= G and (splits - 1) * per < G <= splits * per
    tiles, wave = F // tqm._RN, tqm._ROW_CTAS_PER_SM * tqm._SMS
    assert splits == 1 or (per % tqm._RWARPS == 0 and tiles * splits <= wave)
    assert not any(s > splits and -(-G // s) % tqm._RWARPS == 0
                   and (s - 1) * -(-G // s) < G and tiles * s <= wave
                   for s in range(2, G + 1))
    assert tqm.qmm_splits(B, F, G) == tqm.qmm_splits(1, F, G)


def _cu_constants():
    """``constexpr int NAME = value;`` lines of the kernels' source."""
    src = (ROOT / "deepspeed_tpu_torch/csrc/quant_matmul.cu").read_text()
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"^constexpr int (\w+) = (\d+);", src, re.M)}


def test_wrapper_tiles_are_the_kernels():
    """The split rule's tile sizes are the kernels' own: the decode
    kernel's columns and warps a CTA, and the CTAs an SM its shared memory
    allows (a warp's ring of RSTAGES slots of RB packed rows of RN bytes
    with 16 bytes of skew, their x columns for 16 rows, RN scales; 228 KB
    an SM, 1 KB of it reserved a CTA); the tile kernel's rows and columns a
    CTA."""
    c = _cu_constants()
    assert (c["RN"], c["RWARPS"], c["TM"], c["TN"]) == (
        tqm._RN, tqm._RWARPS, tqm._TM, tqm._TN)
    assert tqm.MAX_ROWS == 2 * c["TM"]        # B=256 is two row tiles
    for bits in (4, 8):
        for nt in (1, 2):
            xk = c["RB"] * (1 if bits == 8 else 2)
            stage = (c["RB"] * (c["RN"] + 16) + nt * 8 * (xk + 8) * 2
                     + c["RN"] * 2)
            cta = c["RWARPS"] * c["RSTAGES"] * stage + 1024 + 256
            assert 233472 // cta == tqm._ROW_CTAS_PER_SM, (bits, nt, cta)
    assert c["RSTAGES"] >= 4
    assert tqm.qmm_splits(6, 128256, 32) == 1
    assert 128256 // c["RN"] <= c["MAX_TILES"]    # the head has a ticket


def _rows_kernel_body(code):
    return code[code.index("qmm_rows_kernel(const"):
                code.index("struct TileSmem")]


def test_rows_kernel_source_keeps_its_contract():
    """The decode kernel (B <= 16): mma.sync m16n8k16 on fragments in
    registers (no wmma, no bf16 tile stored to shared memory and read
    back), the packed bytes turned into A fragments by ldmatrix.trans and
    frag_int8 / frag_int4, a cp.async ring of at least four stages run by
    mbarriers (CTA-wide barriers only after they are set up, before the
    warps' sums are added and around the ticket, none a stage), per-group
    scaling in
    registers from a fresh sum, and its splits added inside the kernel
    behind an atomic ticket: no split_sum_kernel launch at B <= 16."""
    src = (ROOT / "deepspeed_tpu_torch/csrc/quant_matmul.cu").read_text()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    body = _rows_kernel_body(code)
    assert "wmma" not in code and "store_matrix_sync" not in code
    assert "#include <mma.h>" not in code
    for call in ("mma_acc<ZERO>(", "mma_acc<false>(", "ldsm_x4_trans(",
                 "cp_async16(", "mbar_init(", "mbar_wait(",
                 "mbar_arrive_on_copies(", "frag_int8(", "frag_int4(",
                 "atomicAdd(", "__ldcg(", "fmaf("):
        assert call in body, call
    for needle in ("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
                   "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16",
                   "cp.async.cg.shared.global",
                   "cp.async.mbarrier.arrive.noinc.shared::cta.b64"):
        assert needle in code, needle
    assert "mma_bf16_zero(" in code[code.index("void mma_acc("):]
    assert body.count("__syncthreads()") == 4  # set-up, sums, the ticket x2
    assert "__syncthreads()" not in body[body.index("for (int s = 0;"):
                                         body.index("float* sums")]
    assert _cu_constants()["RSTAGES"] >= 4
    # the B <= 16 launch is the kernel alone; the split sum serves B > 16
    launch = code[code.index("int launch_rows("):
                  code.index("int launch_bits(")]
    assert "split_sum_kernel" not in launch and "launch_split" not in launch
    bits = code[code.index("int launch_bits("):code.index("int launch(")]
    assert bits.index("launch_rows<BITS, 2>") < bits.index("launch_split(")


def test_tile_kernel_source_keeps_its_contract():
    """The multi-row kernel: mma.sync on ldmatrix fragments (no wmma), a
    cp.async ring of at least three stages run by mbarriers (one CTA-wide
    barrier, after they are set up, none a stage), the packed bytes turned
    into B fragments in registers (ldmatrix.trans on bytes, then
    frag_int8 / frag_int4), and the per-group scaling in registers."""
    src = (ROOT / "deepspeed_tpu_torch/csrc/quant_matmul.cu").read_text()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    body = code[code.index("qmm_tile_kernel(const"):
                code.index("split_sum_kernel(const")]
    assert "wmma" not in body and "store_matrix_sync" not in body
    assert body.count("__syncthreads()") == 1
    for call in ("mma_bf16(", "mma_bf16_zero(", "ldsm_x4(", "ldsm_x4_trans(",
                 "cp_async16(", "mbar_wait(", "mbar_arrive_on_copies(",
                 "mbar_arrive(", "frag_int8(", "frag_int4("):
        assert call in body, call
    for needle in ("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
                   "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16",
                   "cp.async.cg.shared.global",
                   "cp.async.mbarrier.arrive.noinc.shared::cta.b64"):
        assert needle in code, needle
    assert _cu_constants()["STAGES"] >= 3


@pytest.mark.parametrize("bits", [4, 8])
def test_quantizing_a_transposed_view_gives_kernel_ready_tensors(bits):
    """A tied head is quantized from ``embed.T``: the packed bytes and
    scales must still come out contiguous (the kernels refuse strided
    operands) and equal those of a contiguous copy."""
    w = torch.from_numpy(_w((512, 256), 9)).T
    p, s = tqm.quantize_matmul_weight(w, bits=bits)
    pc, sc = tqm.quantize_matmul_weight(w.contiguous(), bits=bits)
    assert p.is_contiguous() and s.is_contiguous()
    assert torch.equal(p, pc) and torch.equal(s, sc)
