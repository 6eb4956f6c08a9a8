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

from leansdr_tpu_torch.dsp.fft_kernel import (FRAMES, N, fft4096, fft4096_ref,
                                              twiddle_tables)

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


def test_twiddle_tables_within_an_ulp():
    """The CUDA kernel's tables: [4, 64] C-contiguous float32, rows W64^h
    and W4096^l (re, im), each within 1 float32 ulp of its float64 root,
    and W4096^m = W64^(m >> 6) * W4096^(m & 63) (the kernel's product)
    within 2 ulp of the float64 root for every m < 4096."""
    tab = twiddle_tables()
    assert tab.shape == (4, 64) and tab.dtype == np.float32
    assert tab.flags.c_contiguous
    j = np.arange(64)
    want = np.stack([np.cos(2 * np.pi * j / 64), -np.sin(2 * np.pi * j / 64),
                     np.cos(2 * np.pi * j / N), -np.sin(2 * np.pi * j / N)])
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    assert (np.abs(tab - want) <= ulp).all()
    m = np.arange(N)
    a = (tab[0] + 1j * tab[1]).astype(np.complex64)
    b = (tab[2] + 1j * tab[3]).astype(np.complex64)
    w = a[m >> 6] * b[m & 63]
    assert np.abs(w - np.exp(-2j * np.pi * m / N)).max() < 2 * 2.0 ** -24


def _dft16(v):
    """csrc/fft4096.cu dft16 over the last axis in complex64: DFT4 over
    n1 (n = 4 n1 + n0), twiddle W16^(n0 k1), DFT4 over n0, natural
    order out."""
    def dft4(a, b, c, d):
        s02, d02, s13, d13 = a + c, a - c, b + d, b - d
        return s02 + s13, d02 - 1j * d13, s02 - s13, d02 + 1j * d13
    v = v.reshape(v.shape[:-1] + (4, 4))               # [.., n1, n0]
    u = np.stack(dft4(*np.moveaxis(v, -2, 0)), -2)     # [.., k1, n0]
    k = np.arange(4)
    u = u * np.exp(-2j * np.pi * np.outer(k, k) / 16).astype(np.complex64)
    out = np.stack(dft4(*np.moveaxis(u, -1, 0)), -1)   # [.., k1, k2]
    return np.swapaxes(out, -1, -2).reshape(v.shape[:-2] + (16,))


def test_radix16_network_model_matches_numpy():
    """A NumPy model of csrc/fft4096.cu's three passes (the index algebra
    of its header, its dft16 and the twiddles formed from
    twiddle_tables()) in complex64 equals the float64 FFT within the
    2e-5 bar, in natural order."""
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(FRAMES, N))
         + 1j * rng.normal(size=(FRAMES, N))).astype(np.complex64)
    tab = twiddle_tables()
    a = (tab[0] + 1j * tab[1]).astype(np.complex64)
    b = (tab[2] + 1j * tab[3]).astype(np.complex64)

    def tw(m):
        return a[m >> 6] * b[m & 63]

    k = np.arange(16)
    # Pass 1: thread t holds x[256 n2 + t]; DFT over n2; W4096^(t k0).
    y = _dft16(np.swapaxes(x.reshape(FRAMES, 16, 256), 1, 2))  # [B, t, k0]
    y = y * tw(np.outer(np.arange(256), k))
    y = np.swapaxes(y, 1, 2).reshape(FRAMES, 16, 16, 16)       # k0, n1, n0
    # Pass 2: thread (n0, k0) holds n1; DFT over n1; W256^(n0 k1).
    z = _dft16(np.swapaxes(y, 2, 3))                           # k0, n0, k1
    z = z * tw(16 * np.outer(k, k))
    # Pass 3: thread (k1, k0) holds n0; DFT over n0 -> y[k0+16k1+256k2].
    out = _dft16(np.swapaxes(z, 2, 3))                         # k0, k1, k2
    got = np.transpose(out, (0, 3, 2, 1)).reshape(FRAMES, N)
    assert _rel(got, np.fft.fft(x.astype(np.complex128))) < 2e-5
