"""The port's fused 4096-point FFT (leansdr_tpu_torch.dsp.fft_kernel) on
its plain version, against the JAX package's Pallas kernel in interpret
mode and against NumPy.

Tolerance: max|dy| / max|y| < 2e-5, the bar of the JAX package's own
test (tests/test_fft_fir.py::test_fft4096_pallas_matches_numpy): the
four-step sums in float32, in another order than the Pallas kernel's
matrix products and NumPy's float64 FFT. The CUDA kernel is held to the
same bar on the card by chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from leansdr_tpu.dsp.fft_pallas import fft4096_pallas

from leansdr_tpu_torch.dsp.fft_kernel import FRAMES, N, fft4096, fft4096_ref

# Single-threaded torch: the plain versions run many small ops, which
# OpenMP threads only slow down, most of all beside other test workers.
torch.set_num_threads(1)


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def test_fft4096_ref_matches_pallas_and_numpy():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(8, N)) + 1j * rng.normal(size=(8, N))
    xr, xi = (np.asarray(v, np.float32) for v in (x.real, x.imag))
    yr, yi = fft4096(torch.from_numpy(xr), torch.from_numpy(xi))
    got = yr.numpy() + 1j * yi.numpy()
    jr, ji = fft4096_pallas(jnp.asarray(xr), jnp.asarray(xi),
                            interpret=True)
    assert yr.shape == yi.shape == (8, N) and yr.dtype == torch.float32
    assert _rel(got, np.asarray(jr) + 1j * np.asarray(ji)) < 2e-5
    assert _rel(got, np.fft.fft(x)) < 2e-5


def test_fft4096_natural_order_on_tones():
    """A unit tone at bin k comes out as 4096 at index k alone, for bins
    that exercise both digits of k = q*64 + k1."""
    ks = (0, 1, 63, 64, 1000, 4095, 2048, 77)
    t = np.arange(N)
    x = np.exp(2j * np.pi * np.outer(ks, t) / N)
    yr, yi = fft4096_ref(torch.tensor(x.real, dtype=torch.float32),
                         torch.tensor(x.imag, dtype=torch.float32))
    want = np.zeros((len(ks), N))
    want[np.arange(len(ks)), ks] = N
    assert _rel(yr.numpy() + 1j * yi.numpy(), want) < 2e-5


@pytest.mark.parametrize("fn", [fft4096, fft4096_ref])
def test_fft4096_batch_guard(fn):
    """B must be a multiple of FRAMES, as for fft4096_pallas."""
    x = torch.zeros((FRAMES + 4, N))
    with pytest.raises(ValueError, match="multiple of 8"):
        fn(x, x)
