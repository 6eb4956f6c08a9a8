"""Batched DFT as float32 matrix products (the counterpart of
leansdr_tpu/dsp/fft.py: `fft_planes`, and `fft` on complex64 tensors;
the cfft_engine equivalent, reference dsp.h:56-116).

The JAX package computes SDR-sized transforms (64..4096 points) batched
over many frames as matrix products outside any Pallas kernel: a direct
DFT matmul for N <= 256, and the four-step (Cooley-Tukey N = N1*N2)
decomposition — DFT(N1) matmul, twiddle multiply, DFT(N2) matmul — for
larger N. This is the same arithmetic on (re, im) float32 planes, the
products in torch.matmul with TF32 off (a plain matrix product left to
the library, as JAX left it to XLA). The fixed-size fft4096 kernel
(dsp/fft_kernel.py) is another function: one size, the --acq search's.
"""

from functools import lru_cache

import numpy as np
import torch

from ..device import fp32_matmul


@lru_cache(maxsize=None)
def _dft_mats(n: int):
    k = np.arange(n)
    w = np.exp(-2j * np.pi * np.outer(k, k) / n)
    return (w.real.astype(np.float32), w.imag.astype(np.float32))


@lru_cache(maxsize=None)
def _twiddles(n1: int, n2: int):
    t = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n2))
               / (n1 * n2))
    return (t.real.astype(np.float32), t.imag.astype(np.float32))


@lru_cache(maxsize=32)
def _on(device: torch.device, kind: str, *key):
    """The NumPy tables of `kind` moved to `device` (cached)."""
    wr, wi = (_dft_mats if kind == "dft" else _twiddles)(*key)
    if kind == "tw":                         # [n2, n1], as the core uses
        wr, wi = wr.T, wi.T
    return (torch.from_numpy(np.ascontiguousarray(wr)).to(device),
            torch.from_numpy(np.ascontiguousarray(wi)).to(device))


def _dft_matmul(xr, xi, n):
    wr, wi = _on(xr.device, "dft", n)
    yr = torch.matmul(xr, wr) - torch.matmul(xi, wi)
    yi = torch.matmul(xr, wi) + torch.matmul(xi, wr)
    return yr, yi


def _split(n: int):
    n1 = 1 << (int(np.log2(n)) // 2)
    return n1, n // n1


def _fft_core(xr, xi, n: int):
    if n <= 256:
        return _dft_matmul(xr, xi, n)
    n1, n2 = _split(n)
    shape = xr.shape[:-1]
    # x[a*n2 + b] -> view [n1, n2]; column DFT over a, twiddle, row DFT
    # over b, output index (b*n1 + a).
    xr2 = xr.reshape(*shape, n1, n2).transpose(-1, -2)   # [..., n2, n1]
    xi2 = xi.reshape(*shape, n1, n2).transpose(-1, -2)
    ar, ai = _fft_core(xr2, xi2, n1)                     # DFT_{n1}
    tr, ti = _on(xr.device, "tw", n1, n2)                # [n2, n1]
    br = ar * tr - ai * ti
    bi = ar * ti + ai * tr
    br = br.transpose(-1, -2)                            # [..., n1, n2]
    bi = bi.transpose(-1, -2)
    cr, ci = _fft_core(br, bi, n2)                       # [..., n1, n2]
    # Output index k = q*n1 + a -> transpose to [q, a] and flatten.
    cr = cr.transpose(-1, -2).reshape(*shape, n)
    ci = ci.transpose(-1, -2).reshape(*shape, n)
    return cr, ci


def fft_planes(xr: torch.Tensor, xi: torch.Tensor, n: int):
    """Batched forward DFT of the last axis (length n, a power of two;
    FFTW's sign, -1). xr/xi: [..., n] float32 planes. Returns (yr, yi)."""
    if xr.shape[-1] != n or xi.shape != xr.shape:
        raise ValueError(f"planes {tuple(xr.shape)}, {tuple(xi.shape)}: "
                         f"expected [..., {n}] each")
    with fp32_matmul():
        return _fft_core(xr, xi, n)


def fft(x: torch.Tensor) -> torch.Tensor:
    """complex64 [..., n] forward DFT through fft_planes."""
    n = x.shape[-1]
    yr, yi = fft_planes(x.real.contiguous(), x.imag.contiguous(), n)
    return torch.complex(yr, yi)
