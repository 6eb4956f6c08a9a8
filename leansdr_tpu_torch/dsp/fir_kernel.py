"""Causal FIR with runtime taps, and the streaming --resample filter on it
(the counterpart of leansdr_tpu/dsp/fir_pallas.py).

  cfir(x, taps_r, taps_i, start=0, step=1, count=None)
                           complex taps on one (re, im) row pair [2, n],
                           the outputs t = start + j*step, j < count
  fir(x, taps)             real taps on R rows [R, n]

y[r, t] = sum_k taps[k] * x[r, t - k], zeros before the stream head. For
CUDA tensors both launch csrc/fir.cu (`cfir_launch`, `fir_launch`); for
CPU tensors they run `cfir_ref` / `fir_ref`, the plain PyTorch versions
of the same float32 arithmetic in the same order (acc_r = acc_r + wr*sr -
wi*si, ...), which the kernel (built with --fmad=false) equals bit for
bit. The JAX kernels pad n to a multiple of their 2048-sample block; the
port takes any n.

`FirFilterDevice` is fir_filter (reference dsp.h:219-285) on `cfir`:
carrier-re-modulated complex taps, decimation and history, with the
streaming contract of leansdr_tpu/dsp/fir_pallas.py:103-157.
"""

import ctypes

import numpy as np
import torch

from .. import device as _dev
from ..util import trace

MAX_TAPS = 2048          # the taps sit in the kernel's shared memory


def _outputs(n: int, start: int, step: int, count) -> int:
    """The number of outputs of cfir's (start, step, count), checked
    against the input length n (count None: every t < n from start)."""
    if start < 0 or step < 1:
        raise ValueError(f"start={start}, step={step}: need start >= 0 "
                         "and step >= 1")
    if count is None:
        count = max(0, -(-(n - start) // step))
    if count < 0 or (count and start + (count - 1) * step >= n):
        raise ValueError(f"start={start}, step={step}, count={count}: "
                         f"past the {n} input samples")
    return count


def cfir_ref(x: torch.Tensor, taps_r: torch.Tensor, taps_i: torch.Tensor,
             start: int = 0, step: int = 1, count=None) -> torch.Tensor:
    """Plain PyTorch complex-tap causal FIR: x [2, n] float32 (re, im
    rows), taps_r/taps_i [nt] float32. Returns [2, count], the outputs at
    t = start + j*step (the full-rate output, sliced)."""
    nt = taps_r.shape[0]
    n = x.shape[1]
    count = _outputs(n, start, step, count)
    ext = torch.cat([x.new_zeros((2, nt - 1)), x], dim=1)
    acc_r = x.new_zeros(n)
    acc_i = x.new_zeros(n)
    for k in range(nt):
        sr = ext[0, nt - 1 - k: nt - 1 - k + n]
        si = ext[1, nt - 1 - k: nt - 1 - k + n]
        wr, wi = taps_r[k], taps_i[k]
        acc_r = acc_r + wr * sr - wi * si
        acc_i = acc_i + wr * si + wi * sr
    return torch.stack([acc_r, acc_i])[
        :, start:start + count * step:step].contiguous()


def fir_ref(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch real-tap causal FIR over the last axis of x [R, n]
    float32, taps [nt] float32. Returns [R, n]."""
    nt = taps.shape[0]
    R, n = x.shape
    ext = torch.cat([x.new_zeros((R, nt - 1)), x], dim=1)
    acc = x.new_zeros((R, n))
    for k in range(nt):
        acc = acc + taps[k] * ext[:, nt - 1 - k: nt - 1 - k + n]
    return acc


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _dev.load("fir")
        lib.cfir_launch.restype = ctypes.c_int
        lib.cfir_launch.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.fir_launch.restype = ctypes.c_int
        lib.fir_launch.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        _lib = lib
    return _lib


def _check_taps(nt: int):
    if not 1 <= nt <= MAX_TAPS:
        raise ValueError(f"{nt} taps: the FIR kernel takes 1..{MAX_TAPS}")


def cfir(x: torch.Tensor, taps_r: torch.Tensor, taps_i: torch.Tensor,
         start: int = 0, step: int = 1, count=None) -> torch.Tensor:
    """Causal complex FIR at t = start + j*step, j < count (same
    contract as cfir_ref; the defaults are every output). CPU tensors run
    `cfir_ref`; CUDA tensors launch csrc/fir.cu, which computes only
    those outputs."""
    if x.device.type == "cpu":
        return cfir_ref(x, taps_r, taps_i, start, step, count)
    nt = taps_r.shape[0]
    _check_taps(nt)
    n = x.shape[1]
    count = _outputs(n, start, step, count)
    dev = x.device
    _dev.check_tensor("x", x, torch.float32, (2, n), dev)
    _dev.check_tensor("taps_r", taps_r, torch.float32, (nt,), dev)
    _dev.check_tensor("taps_i", taps_i, torch.float32, (nt,), dev)
    y = torch.empty((2, count), dtype=torch.float32, device=dev)
    if count:
        with trace.span("kernel.cfir"):
            err = _kernel().cfir_launch(taps_r.data_ptr(), taps_i.data_ptr(),
                                        x.data_ptr(), y.data_ptr(), n, nt,
                                        start, step, count,
                                        _dev.stream_handle(x))
        _dev.check_launch("cfir", err)
        trace.count("launch.cfir")
    return y


def fir(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Causal real-tap FIR over the rows of x [R, n] (same contract as
    fir_ref). CPU tensors run `fir_ref`; CUDA tensors launch
    csrc/fir.cu."""
    if x.device.type == "cpu":
        return fir_ref(x, taps)
    nt = taps.shape[0]
    _check_taps(nt)
    R, n = x.shape
    dev = x.device
    _dev.check_tensor("x", x, torch.float32, (R, n), dev)
    _dev.check_tensor("taps", taps, torch.float32, (nt,), dev)
    y = torch.empty_like(x)
    if n and R:
        with trace.span("kernel.fir"):
            err = _kernel().fir_launch(taps.data_ptr(), x.data_ptr(),
                                       y.data_ptr(), R, n, nt,
                                       _dev.stream_handle(x))
        _dev.check_launch("fir", err)
        trace.count("launch.fir")
    return y


class FirFilterDevice:
    """Streaming fir_filter (dsp.h:219-285) on the complex FIR kernel:
    carrier-re-modulated complex taps, decimation, history (the
    --resample stage of the single-carrier receiver). The kernel computes
    only the outputs that decimation keeps.

    Contract of leansdr_tpu/dsp/fir_pallas.py:103-157: taps re-modulated
    on the host in float64 and cast to float32 when the tracked carrier
    moves by more than freq_tol; the first n samples of the stream are
    dropped (history priming); outputs at n + j*decim of the buffered
    stream."""

    def __init__(self, coeffs: np.ndarray, decim: int = 1,
                 freq_tol: float = 0.1, device=None):
        self.device = _dev.resolve_device(device)
        self.coeffs = np.asarray(coeffs, np.float32)
        self.n = len(self.coeffs)
        _check_taps(self.n)
        self.decim = decim
        self.freq_tol = freq_tol
        self.current_freq = 0.0
        self._set_freq(0.0)
        self.hist = np.zeros(self.n, np.complex64)
        self._primed = False

    def _set_freq(self, f: float):
        i = np.arange(self.n)
        a = 2 * np.pi * f * (i - self.n // 2)
        self.taps_r = torch.from_numpy(
            (self.coeffs * np.cos(a)).astype(np.float32)).to(self.device)
        self.taps_i = torch.from_numpy(
            (self.coeffs * np.sin(a)).astype(np.float32)).to(self.device)
        self.current_freq = f

    def state(self) -> dict:
        """The streaming state (what a checkpoint carries)."""
        return {"current_freq": self.current_freq, "hist": self.hist,
                "_primed": self._primed}

    def set_state(self, st: dict):
        self.hist = np.asarray(st["hist"], np.complex64)
        self._primed = bool(st["_primed"])
        self._set_freq(float(st["current_freq"]))

    def process(self, x: np.ndarray, freq_tap: float = None) -> np.ndarray:
        """[n] complex64 in -> decimated complex64 out."""
        if freq_tap is not None and \
           abs(self.current_freq - freq_tap) > self.freq_tol:
            self._set_freq(freq_tap)
        buf = np.concatenate([self.hist, np.asarray(x, np.complex64)])
        if not self._primed:
            buf = buf[self.n:]
            self._primed = True
        count = (len(buf) - self.n) // self.decim
        if count <= 0:
            self.hist = buf[-min(len(buf), self.n + self.decim - 1):]
            return np.empty(0, np.complex64)
        planes = np.stack([buf.real, buf.imag]).astype(np.float32)
        xd = torch.from_numpy(planes).to(self.device)
        yv = cfir(xd, self.taps_r, self.taps_i, start=self.n,
                  step=self.decim, count=count).cpu().numpy()
        out = (yv[0] + 1j * yv[1]).astype(np.complex64)
        self.hist = buf[count * self.decim:]
        return out
