"""The port's device-memory probe (``tools/hbm_bandwidth.py``, kernel K's
op) on the CPU: :func:`plain_hbm_stream` against numpy's float64 sum of the
reference's probe array (``arange`` of 1Mi fp32 values, the reference's CPU
size) for several block-order offsets (rel 1e-12: both sum exactly
representable values in float64), and ``measure_hbm_bandwidth``'s keys. A
time measured here is the host's, never the card's: only the keys and
their positivity are checked."""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.tools import hbm_bandwidth as hb
from tests._torch_threads import one_torch_thread  # noqa: F401


def _probe_array():
    return torch.arange(1024 * 1024, dtype=torch.float32).reshape(-1, hb.ROW)


@pytest.mark.parametrize("offset", [0, 3, 17])
def test_plain_stream_sum_matches_numpy(offset):
    x = _probe_array()
    want = np.sum(x.numpy(), dtype=np.float64)
    got = hb.hbm_stream(x, offset)
    assert got.dtype == torch.float64 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=1e-12)
    assert float(hb.plain_hbm_stream(x, offset)) == float(got)


def test_stream_sum_of_random_values():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((256, 1024)).astype(np.float32)
    np.testing.assert_allclose(float(hb.plain_hbm_stream(torch.from_numpy(x))),
                               np.sum(x, dtype=np.float64), rtol=1e-10)


def test_kernel_operand_checks():
    with pytest.raises(ValueError, match="multiple of 64"):
        hb.hbm_stream_kernel_args(torch.zeros(100, 1024))


def test_measure_keys_on_the_cpu():
    rates = hb.measure_hbm_bandwidth(device="cpu")
    assert set(rates) == {"copy_rw_gbps", "stream_read_gbps"}
    assert all(v > 0 for v in rates.values())


def test_measure_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hb.measure_hbm_bandwidth()
