"""Matched-filter prefilter for the fast RRC path (the counterpart of
leansdr_tpu/dsp/mf_prefilter.py:39-100).

The reference's `fir_sampler` (sdr.h:635-689) runs a polyphase RRC
matched filter inside the per-sample timing loop, with taps pre-rotated
by the carrier estimate. Here the matched filter runs ONCE at input rate
before the demodulator, which then samples the filtered stream with the
linear sampler. Each channel's taps are rotated by its current freqw
estimate, re-derived once per chunk; the rotation factors out of the
convolution:

    sum_k c[k] e^{-iw(k-h)} x[t+k]
      = e^{iw(t+h)} * sum_k c[k] (e^{-iws} x[s])|_{s=t+k}

so the chain is derotate -> REAL-tap VALID FIR -> re-rotate. Rotation
phases are wrapped mod 65536 in the integer domain before the 2*pi
scaling, exactly as the JAX version does, so cos/sin never see large
arguments.
"""

import numpy as np
import torch

from . import filtergen
from .fir_mxu import fir_valid


def make_mf_taps(Fs_eff: float, Fm: float, rolloff: float,
                 rej: float) -> tuple:
    """Input-rate root-raised-cosine taps (filtergen.h:151-173 sampled at
    the input rate instead of the polyphase oversampled rate)."""
    transition = (Fm / 2) * rolloff
    order = int(rej * Fs_eff / (22 * transition))
    taps = filtergen.root_raised_cosine(order, Fm / Fs_eff, rolloff)
    return tuple(float(t) for t in taps)


_K = float(np.float32(2 * np.pi / 65536.0))


def mf_prefilter(taps: tuple, freqw: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """[C, n + ntaps - 1, 2] float32 -> [C, n, 2] matched-filtered.

    taps: input-rate RRC taps. freqw: [C] current carrier step (u16
    units/sample); the passband tracks each channel's carrier
    (sdr.h:676-681).
    """
    dev = x.device
    c = torch.tensor(taps, dtype=torch.float32, device=dev)
    ntaps = c.shape[0]
    C, S, _ = x.shape
    n = S - (ntaps - 1)
    h = ntaps // 2
    s = torch.arange(S, dtype=torch.int32, device=dev)[None, :]   # [1, S]
    # Phase in u16 units, wrapped exactly: the integer part of freqw
    # times s wraps in int32 (mod 2^16 after masking), the fractional
    # part's product stays small enough for float32.
    fi = torch.floor(freqw)[:, None]
    ff = freqw[:, None] - fi
    ph = (((fi.to(torch.int32) * s) & 0xFFFF).to(torch.float32)
          + ff * s.to(torch.float32))
    ang = -_K * ph                                                # [C, S]
    dr, di = torch.cos(ang), torch.sin(ang)
    xr, xi = x[:, :, 0], x[:, :, 1]
    ur = xr * dr - xi * di                  # u = e^{-iws} x
    ui = xr * di + xi * dr
    v = fir_valid(torch.cat([ur, ui]), c)                         # [2C, n]
    vr, vi = v[:C], v[C:]
    ang2 = -ang[:, :n] + _K * (torch.remainder(freqw[:, None], 65536.0)
                               * float(h))
    rr, ri = torch.cos(ang2), torch.sin(ang2)   # e^{iw(t+h)}
    zr = vr * rr - vi * ri
    zi = vr * ri + vi * rr
    return torch.stack([zr, zi], dim=-1)
