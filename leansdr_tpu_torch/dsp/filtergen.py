"""Filter design, mirroring the closed forms of filtergen.h (a NumPy copy
of leansdr_tpu/dsp/filtergen.py).

Setup-time only; coefficients are computed in float32 where the
reference uses float, so they equal the JAX package's taps bit for bit.
"""

import numpy as np


def normalize_power(coeffs: np.ndarray, gain: float = 1.0) -> np.ndarray:
    """Scale so that sum of squares is gain^2 (filtergen.h:26-32)."""
    c = np.asarray(coeffs, dtype=np.float32)
    s2 = float(np.sum(c.astype(np.float64) ** 2))
    if s2:
        gain = gain / np.sqrt(s2)
    return (c * np.float32(gain)).astype(np.float32)


def normalize_dcgain(coeffs: np.ndarray, gain: float = 1.0) -> np.ndarray:
    """Scale so that the DC gain is `gain` (filtergen.h:34-40)."""
    c = np.asarray(coeffs, dtype=np.float32)
    s = float(np.sum(c.astype(np.float64)))
    if s:
        gain = gain / s
    return (c * np.float32(gain)).astype(np.float32)


def lowpass(order: int, fcut: float, gain: float = 1.0) -> np.ndarray:
    """Windowed-sinc lowpass, window disabled like the reference
    (filtergen.h:45-62). ncoeffs = order+1; normalized to DC gain."""
    ncoeffs = order + 1
    i = np.arange(ncoeffs, dtype=np.float64)
    t = i - (ncoeffs - 1) * 0.5
    x = 2 * np.pi * fcut * t
    sinc = 2 * fcut * np.where(t != 0, np.divide(np.sin(x), x,
                                                 out=np.ones_like(x),
                                                 where=(t != 0)), 1.0)
    return normalize_dcgain(sinc.astype(np.float32), gain)


def root_raised_cosine(order: int, fs: float, rolloff: float) -> np.ndarray:
    """Closed-form RRC taps (filtergen.h:68-92).

    `fs` is the symbol rate as a fraction of the filter's sampling rate
    (i.e. Fm/Frrc). ncoeffs = (order+1)|1 (odd). DC-normalized.
    """
    B = float(rolloff)
    pi = np.pi
    ncoeffs = (order + 1) | 1
    t = np.arange(ncoeffs, dtype=np.float64) - ncoeffs // 2
    tT = t * fs

    den = pi * tT * (1 - (4 * B * tT) ** 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        general = np.sqrt(fs) * (
            np.sin(pi * tT * (1 - B)) + 4 * B * tT * np.cos(pi * tT * (1 + B))
        ) / den
    singular = B * np.sqrt(fs / 2) * (
        (1 + 2 / pi) * np.sin(pi / (4 * B)) + (1 - 2 / pi) * np.cos(pi / (4 * B))
    )
    c = np.where(den == 0, singular, general)
    c[t == 0] = np.sqrt(fs) * (1 - B + 4 * B / pi)
    return normalize_dcgain(c.astype(np.float32))


def dump_filter(name: str, coeffs: np.ndarray, f=None) -> str:
    """Print taps in octave format (filtergen.h:97-102)."""
    import sys
    s = f"{name} = [" + ",".join(f" {c:f}" for c in coeffs) + " ];"
    print(s, file=f or sys.stderr)
    return s
