"""Channel impairment simulator (reference leanchansim.cc; a copy of
leansdr_tpu/pipelines/chansim.py, over the port's own trig16 table).

scale -> complex AWGN (Marsaglia polar over drand48, wgn_c dsp.h:164-190)
-> 3-component sinusoidal LO drift (drifter, leanchansim.cc:34-83).

The reference's --deterministic mode means drand48 runs from its default
seed; we emulate the exact LCG (X' = 0x5DEECE66D*X + 0xB mod 2^48) with a
vectorized doubling construction so deterministic noise matches the
reference draw-for-draw, enabling apples-to-apples BER curves.
"""

from dataclasses import dataclass, field

import numpy as np

_A = 0x5DEECE66D
_C = 0xB
_M48 = (1 << 48) - 1
# glibc initializes the drand48 state to zero when srand48 was never
# called (the documented 0x1234ABCD330E applies to seed48/lcong48);
# the first drand48() value is therefore c/2^48.
DRAND48_DEFAULT_SEED = 0


def _lcg_mul48(a: int, x: np.ndarray) -> np.ndarray:
    """(a * x) mod 2^48 for uint64 arrays without overflow (24-bit split)."""
    a = np.uint64(a)
    lo = x & np.uint64(0xFFFFFF)
    hi = x >> np.uint64(24)
    part = (a * hi) & np.uint64(0xFFFFFF)
    return ((part << np.uint64(24)) + a * lo) & np.uint64(_M48)


def drand48_sequence(n: int, seed: int = DRAND48_DEFAULT_SEED) -> np.ndarray:
    """First n drand48() values (as exact float64) from the given state.

    Vectorized by doubling: X[k+m] = a^m * X[k] + c*(a^m-1)/(a-1) mod 2^48.
    """
    if n == 0:
        return np.empty(0)
    xs = np.array([(_A * seed + _C) & _M48], dtype=np.uint64)
    a_m, c_m = _A, _C
    while len(xs) < n:
        nxt = (_lcg_mul48(a_m, xs) + np.uint64(c_m)) & np.uint64(_M48)
        xs = np.concatenate([xs, nxt])
        c_m = (a_m * c_m + c_m) & _M48
        a_m = (a_m * a_m) & _M48
    return xs[:n].astype(np.float64) / float(1 << 48)


def drand48_jump(k: int, seed: int = DRAND48_DEFAULT_SEED) -> int:
    """drand48 state after k draws from `seed` (O(log k) LCG jump).

    Feeding the result back as `seed` continues the stream exactly:
    chunked noise generation matches one continuous draw sequence."""
    a, c, x = _A, _C, int(seed)
    while k:
        if k & 1:
            x = (a * x + c) & _M48
        c = (a * c + c) & _M48
        a = (a * a) & _M48
        k >>= 1
    return x


def wgn_c(nsamples: int, stddev: float, seed: int = DRAND48_DEFAULT_SEED):
    """Complex AWGN exactly as wgn_c (dsp.h:172-183).

    Each output consumes drand48 pairs until x^2+y^2 in (0,1); the
    rejection consumes exactly one pair per attempt, so the accepted pairs
    of the linear draw sequence are the outputs in order.
    Returns ([nsamples,2] float32, ndraws_consumed).
    """
    out = np.empty((0, 2), dtype=np.float32)
    draws_used = 0
    need = nsamples
    # Acceptance rate is pi/4; draw with margin and top up if unlucky.
    est = int(need / 0.78) + 64
    while need > 0:
        d = drand48_sequence(draws_used + 2 * est, seed)[draws_used:]
        x = (2 * d[0::2] - 1).astype(np.float32)
        y = (2 * d[1::2] - 1).astype(np.float32)
        r2 = x * x + y * y
        ok = (r2 != 0) & (r2 < 1)
        with np.errstate(invalid="ignore"):
            k = np.sqrt(-np.log(r2, where=ok, out=np.ones_like(r2))
                        / np.where(ok, r2, 1)
                        ).astype(np.float32) * np.float32(stddev)
        acc = np.stack([k * x, k * y], axis=-1)[ok]
        if len(acc) >= need:
            # Find how many pairs were consumed to produce `need` samples.
            idx = np.where(ok)[0][need - 1]
            draws_used += 2 * (idx + 1)
            out = np.concatenate([out, acc[:need].astype(np.float32)])
            need = 0
        else:
            draws_used += 2 * est
            out = np.concatenate([out, acc.astype(np.float32)])
            need -= len(acc)
            est = int(need / 0.78) + 64
    return out[:nsamples], draws_used


@dataclass
class DriftComponent:
    amp: float = 0.0    # amplitude of frequency fluctuation (cycles/sample)
    freq: float = 0.0   # rate of fluctuation (cycles/sample)


@dataclass
class ChansimConfig:
    scale: float = 1.0
    awgn: float = 0.0
    deterministic: bool = False   # reference default: getpid() seed
    seed: int | None = None      # non-deterministic runs pick a seed
    drifts: tuple = (DriftComponent(), DriftComponent(), DriftComponent())


def drifter(x: np.ndarray, drifts) -> np.ndarray:
    """Sinusoidal LO drift (leanchansim.cc:57-76): a 16-bit phase
    accumulator advanced by the sum of sinusoidal frequency components,
    rotation via the 65536-entry trig LUT."""
    from ..dsp.math_utils import trig16_table
    lut = trig16_table()
    n = len(x)
    active = [d for d in drifts if d.amp or d.freq]
    if not active:
        # f == 0 every sample: rotation by lut[0] == (1, 0) — identity.
        return x.astype(np.float32)
    # Per-sample frequency sum (vectorized; 32-bit phase accumulators).
    f = np.zeros(n, dtype=np.float64)
    for d in active:
        step = int(d.freq * 4294967296.0)
        a = (np.arange(n, dtype=np.int64) * step)  # phase before sample t
        idx = ((a >> 16) & 0xFFFF).astype(np.int64)
        f += d.amp * lut[idx, 1]
    phase = np.cumsum((f * 65536).astype(np.float32).astype(np.int16)
                      .astype(np.int32))
    idx = (phase.astype(np.int64)) & 0xFFFF
    c, s = lut[idx, 0], lut[idx, 1]
    out = np.empty_like(x, dtype=np.float32)
    out[:, 0] = x[:, 0] * c - x[:, 1] * s
    out[:, 1] = x[:, 0] * s + x[:, 1] * c
    return out


def simulate(iq: np.ndarray, cfg: ChansimConfig) -> np.ndarray:
    """Apply the channel to [n,2] float32 IQ."""
    x = np.asarray(iq, dtype=np.float32) * np.float32(cfg.scale)
    if cfg.awgn:
        # An explicit seed is deterministic by construction (srand48
        # semantics: state = seed<<16 | 0x330E) and takes precedence;
        # --deterministic alone keeps the reference's default stream.
        seed = (((cfg.seed << 16) | 0x330E) & _M48
                if cfg.seed is not None else DRAND48_DEFAULT_SEED)
        noise, _ = wgn_c(len(x), cfg.awgn, seed)
        x = x + noise
    x = drifter(x, cfg.drifts)
    return x.astype(np.float32)
