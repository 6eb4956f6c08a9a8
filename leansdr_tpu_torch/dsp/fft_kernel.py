"""Batched 4096-point forward DFT (the counterpart of
leansdr_tpu/dsp/fft_pallas.py, the JAX package's FFT study kernel).

`fft4096(xr, xi)` takes [B, 4096] float32 real and imaginary planes (B a
multiple of FRAMES) and returns (yr, yi) [B, 4096], the DFT in natural
order.

CUDA tensors launch csrc/fft4096.cu, a radix-16 network (three passes
of 16-point DFTs; the index algebra is in the source) whose inter-pass
twiddles W4096^m are W64^(m >> 6) * W4096^(m & 63) from the two 64-entry
tables of `twiddle_tables`. CPU tensors run `fft4096_ref`, the JAX
kernel's 64 x 64 four-step: with x[a*64 + b],

    D[b, k1] = sum_a x[a*64 + b] W64^(a*k1)        DFT over a
    B[b, k1] = D[b, k1] * W4096^(b*k1)             twiddle
    y[q*64 + k1] = sum_b B[b, k1] W64^(b*q)        DFT over b

as two float32 matrix products (TF32 off) over the packed real block
matrix [[Wr, Wi], [-Wi, Wr]], with the tables built in float64 and cast
to float32 as the JAX kernel builds them. The two sum in different
orders, so they agree to float32 rounding (the JAX tests' bar,
max|dy| / max|y| < 2e-5), not bit for bit.
"""

import ctypes
from functools import lru_cache

import numpy as np
import torch

from .. import device as _dev

N = 4096
N1 = 64          # x[a*64 + b]: DFT_64 over a, twiddle, DFT_64 over b
FRAMES = 8       # B must be a multiple of this (the JAX kernel's tile)


@lru_cache(maxsize=None)
def _packed_dft(n: int) -> np.ndarray:
    """[[Wr, Wi], [-Wi, Wr]] for the n-point DFT, [2n, 2n] float32."""
    k = np.arange(n)
    w = np.exp(-2j * np.pi * np.outer(k, k) / n)
    wr, wi = w.real.astype(np.float32), w.imag.astype(np.float32)
    return np.block([[wr, wi], [-wi, wr]])


@lru_cache(maxsize=None)
def _twiddle_parts():
    """The twiddle t[b, k1] = W4096^(b*k1) as float32 (re, im) [64, 64]."""
    t = np.exp(-2j * np.pi * np.outer(np.arange(N1), np.arange(N1)) / N)
    return (t.real.T.astype(np.float32).copy(),
            t.imag.T.astype(np.float32).copy())


@lru_cache(maxsize=None)
def twiddle_tables() -> np.ndarray:
    """The CUDA kernel's twiddle tables, float32 [4, 64] C-contiguous:
    rows W64^h re, im and W4096^l re, im for h, l = 0..63, each computed
    in float64 and rounded to float32 once. The kernel forms W4096^m
    (0 <= m < 4096) as row pair 0-1 at m >> 6 times row pair 2-3 at
    m & 63."""
    j = np.arange(N1)
    a = np.exp(-2j * np.pi * j / N1)
    b = np.exp(-2j * np.pi * j / N)
    return np.ascontiguousarray(
        np.stack([a.real, a.imag, b.real, b.imag]).astype(np.float32))


def _batch(xr: torch.Tensor) -> int:
    """B of [B, 4096] planes; raises unless it is a multiple of FRAMES."""
    B = xr.shape[0]
    if B % FRAMES:
        raise ValueError(f"B={B} not a multiple of {FRAMES}")
    return B


def fft4096_ref(xr: torch.Tensor, xi: torch.Tensor):
    """Plain PyTorch four-step: [B, 4096] float32 planes -> (yr, yi)."""
    B = _batch(xr)
    dev = xr.device
    w = torch.from_numpy(_packed_dft(N1)).to(dev)
    twr, twi = (torch.from_numpy(t).to(dev) for t in _twiddle_parts())
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x3 = torch.cat([xr.reshape(B, N1, N1), xi.reshape(B, N1, N1)],
                       dim=1)                          # [B, 2a, b]
        d = x3.transpose(1, 2) @ w                     # [B, b, 2k1]
        dr, di = d[..., :N1], d[..., N1:]
        b3 = torch.cat([dr * twr - di * twi, dr * twi + di * twr],
                       dim=1)                          # [B, 2b, k1]
        y = w.T @ b3                                   # [B, 2q, k1]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return (y[:, :N1].reshape(B, N).contiguous(),
            y[:, N1:].reshape(B, N).contiguous())


_lib = None
_tables = {}


def _kernel():
    global _lib
    if _lib is None:
        lib = _dev.load("fft4096")
        lib.fft4096_launch.restype = ctypes.c_int
        lib.fft4096_launch.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_void_p]
        _lib = lib
    return _lib


def _device_tables(dev: torch.device) -> torch.Tensor:
    """`twiddle_tables()` on dev, made once per device."""
    if dev not in _tables:
        _tables[dev] = torch.from_numpy(twiddle_tables()).to(dev)
    return _tables[dev]


def fft4096(xr: torch.Tensor, xi: torch.Tensor):
    """Batched 4096-point forward DFT of [B, 4096] float32 planes (B a
    multiple of FRAMES) -> (yr, yi). CPU tensors run `fft4096_ref`; CUDA
    tensors launch csrc/fft4096.cu."""
    if xr.device.type == "cpu":
        return fft4096_ref(xr, xi)
    B = _batch(xr)
    dev = xr.device
    _dev.check_tensor("xr", xr, torch.float32, (B, N), dev)
    _dev.check_tensor("xi", xi, torch.float32, (B, N), dev)
    tables = _device_tables(dev)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    if B:
        err = _kernel().fft4096_launch(
            tables.data_ptr(), xr.data_ptr(), xi.data_ptr(), yr.data_ptr(),
            yi.data_ptr(), B, _dev.stream_handle(xr))
        _dev.check_launch("fft4096", err)
        _FFT.launches += 1
    return yr, yi


# Launch count of the kernel (a plain integer; increments only where the
# kernel launches). Bound through an alias so a caller that rebinds the
# module attribute (e.g. to time it) still counts.
fft4096.launches = 0
_FFT = fft4096
