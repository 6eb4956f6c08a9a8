"""Host NumPy blocks (copies of leansdr_tpu/dsp/blocks.py but for its
AutoNotch, CnrFft, Spectrum and FirFilter, which the port runs on the
card: dsp/blocks_device.py, dsp/fir_kernel.FirFilterDevice), and the
first-order recurrence of the FM receiver.

  decimate  decimator (reference generic.h:247-267)
  Rotator   rotator (reference sdr.h:1228-1261): fixed frequency shift
            through the 65536-entry trig16 table
  adder, scaler, naive_lowpass (dsp.h:118-217); SSEstimator,
            SSAmpEstimator (sdr.h:161-233): the reference's remaining
            small blocks
  _first_order_scan  y_n = (1-k) y_{n-1} + k x_n as an associative scan
            (torch ops, on the tensors' device)
"""

import numpy as np
import torch

from .math_utils import trig16_table


def decimate(x: np.ndarray, d: int) -> np.ndarray:
    """Keep 1 sample in d."""
    return x[::d]


class Rotator:
    """Fixed frequency shift with the 65536-entry LUT quantization:
    freq quantized to n/65536 cycles/sample, 16-bit phase index."""

    def __init__(self, freq: float):
        self.ifreq = int(freq * 65536)
        self.index = 0
        self._trig = trig16_table()

    def process(self, x: np.ndarray) -> np.ndarray:
        n = len(x)
        e = self._trig[((self.index + np.arange(n)) * self.ifreq) & 0xFFFF]
        c, s = e[:, 0], e[:, 1]
        self.index = (self.index + n) & 0xFFFF
        return ((x.real * c - x.imag * s)
                + 1j * (x.real * s + x.imag * c)).astype(np.complex64)


def adder(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """adder<T> (dsp.h:118-138)."""
    return a + b


def scaler(k, x: np.ndarray) -> np.ndarray:
    """scaler<Tscale,Tin,Tout> (dsp.h:140-160)."""
    return np.float32(k) * x


def naive_lowpass(x: np.ndarray, w: int) -> np.ndarray:
    """naive_lowpass (dsp.h:192-217): boxcar average of width w; output
    k is the mean of x[k .. k+w-1] (w-sample lookahead)."""
    c = np.cumsum(np.concatenate([[0], x]))
    n = len(x) - w
    if n <= 0:
        return x[:0]
    k = np.float32(1.0 / w)
    return ((c[w:w + n] - c[:n]) * k).astype(x.dtype)


class SSEstimator:
    """ss_estimator (sdr.h:161-189): RMS over 1024-sample windows."""

    def __init__(self, window_size=1024, decimation=1024):
        self.window = window_size
        self.decimation = decimation
        self.phase = 0
        self.backlog = np.empty(0, np.complex64)

    def process(self, x: np.ndarray):
        self.backlog = np.concatenate([self.backlog, x])
        out = []
        while len(self.backlog) >= self.window:
            w = self.backlog[:self.window]
            self.phase += self.window
            if self.phase >= self.decimation:
                self.phase -= self.decimation
                out.append(np.sqrt(np.mean(w.real ** 2 + w.imag ** 2)))
            self.backlog = self.backlog[self.window:]
        return np.array(out, np.float32)


class SSAmpEstimator:
    """ss_amp_estimator (sdr.h:191-233): RMS plus min/max amplitude per
    window."""

    def __init__(self, window_size=1024, decimation=1024):
        self.window = window_size
        self.decimation = decimation
        self.phase = 0
        self.backlog = np.empty(0, np.complex64)

    def process(self, x: np.ndarray):
        self.backlog = np.concatenate([self.backlog, x])
        out = []
        while len(self.backlog) >= self.window:
            w = self.backlog[:self.window]
            self.phase += self.window
            if self.phase >= self.decimation:
                self.phase -= self.decimation
                mag2 = w.real ** 2 + w.imag ** 2
                mag = np.sqrt(mag2)
                out.append((float(np.sqrt(mag2.mean())),
                            float(mag.min()), float(mag.max())))
            self.backlog = self.backlog[self.window:]
        return out


def _associative_scan(combine, elems: list) -> list:
    """Inclusive scan of `elems` (tensors with a common axis 0) under the
    associative `combine`, by the odd/even recursion of
    jax.lax.associative_scan: combine adjacent pairs, scan those
    recursively (the odd outputs), combine each with the next even
    input (the even outputs), interleave. Each output is combined in the
    same order as JAX's, so both round alike."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = combine([e[0:-1:2] for e in elems], [e[1::2] for e in elems])
    odd = _associative_scan(combine, reduced)
    if n % 2 == 0:
        even = combine([e[:-1] for e in odd], [e[2::2] for e in elems])
    else:
        even = combine(odd, [e[2::2] for e in elems])
    even = [torch.cat([e[:1], r]) for e, r in zip(elems, even)]
    out = []
    for e, o in zip(even, odd):
        # Interleave: e0, o0, e1, o1, ... (e has one more when n is odd).
        # JAX interleaves by adding the two zero-padded halves, so every
        # output is x + 0 (a -0.0 comes out +0.0); so here.
        m = o.shape[0]
        body = torch.stack([e[:m], o], 1).reshape(2 * m, *o.shape[1:])
        out.append(torch.cat([body, e[m:]]) + 0.0)
    return out


def _first_order_scan(bb: torch.Tensor, y0, k: float) -> torch.Tensor:
    """y_n = (1-k)*y_{n-1} + k*bb_n over axis 0 (the counterpart of
    leansdr_tpu/dsp/blocks.py:93-104, which runs jax.lax.associative_scan):
    the pairs (a, b) = (1-k, k*bb) combined as (al*ar, bl*ar + br), then
    a*y0 + b, every operation in float32 in JAX's order. y0 broadcasts
    against bb[0]."""
    a = torch.full_like(bb, float(np.float32(1 - k)))
    b = bb * float(np.float32(k))

    def combine(lt, rt):
        al, bl = lt
        ar, br = rt
        return [al * ar, bl * ar + br]

    a_out, b_out = _associative_scan(combine, [a, b])
    return a_out * y0 + b_out
