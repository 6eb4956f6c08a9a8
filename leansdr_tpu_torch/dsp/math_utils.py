"""Math primitives of the demod loop (torch), the device helpers of
leansdr_tpu/dsp/math_utils.py (cmul, parity_u32, popcount_u32, log2i),
and setup-time NumPy helpers.

16-bit angle convention of the reference (math.h:95-111, sdr.h:277-278):
65536 = 2*pi.

ATAN_COEFFS are fitted exactly as leansdr_tpu/dsp/math_utils.py fits
them (same least-squares problem, same float values), so the demod's
phase error matches the JAX kernel's.
"""

from functools import lru_cache

import numpy as np
import torch


def cmul(a_re, a_im, b_re, b_im):
    """Complex multiply on separate planes (math.h:40-43)."""
    return a_re * b_re - a_im * b_im, a_re * b_im + a_im * b_re


def _u32(x: torch.Tensor) -> torch.Tensor:
    """x's 32-bit patterns as non-negative int64 (torch has few uint32
    operations, and int32's arithmetic right shift drags the sign bit
    in)."""
    return x.to(torch.int64) & 0xFFFFFFFF


def parity_u32(x: torch.Tensor) -> torch.Tensor:
    """XOR-fold parity of each uint32/int32 lane (math.h:73-85), uint8."""
    x = _u32(x)
    for s in (16, 8, 4, 2, 1):
        x = x ^ (x >> s)
    return (x & 1).to(torch.uint8)


def popcount_u32(x: torch.Tensor) -> torch.Tensor:
    """Per-lane popcount (hamming_weight, math.h:56-71), int32."""
    x = _u32(x)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def log2i(x: int) -> int:
    """Integer log2 (math.h:87-91); -1 for 0."""
    n = -1
    while x:
        n += 1
        x >>= 1
    return n


def parity_u64_np(x) -> np.ndarray:
    """NumPy parity for uint64 scalars/arrays (setup-time use)."""
    x = np.asarray(x, dtype=np.uint64)
    for s in (32, 16, 8, 4, 2, 1):
        x = x ^ (x >> np.uint64(s))
    return (x & np.uint64(1)).astype(np.uint8)


# Polynomial atan/atan2: max error < 3e-7 rad, well under the s16 angle
# quantum 2*pi/65536 ~ 9.6e-5.
def _fit_atan_coeffs(order=7):
    r = np.linspace(0, 1, 4001)[1:]
    u = r * r
    A = np.stack([u ** k for k in range(order)], axis=1) * r[:, None]
    c, *_ = np.linalg.lstsq(A, np.arctan(r), rcond=None)
    return tuple(float(v) for v in c)


ATAN_COEFFS = _fit_atan_coeffs()
# The float32 values the kernels use (the CUDA demod gets these).
ATAN_COEFFS_F32 = tuple(float(np.float32(c)) for c in ATAN_COEFFS)
PI_F32 = float(np.float32(np.pi))
HALF_PI_F32 = float(np.float32(np.pi / 2))


def atan2_poly(q: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """atan2(q, i) with C sign conventions, polynomial core; float32,
    one rounding per operation in the order of the JAX version."""
    ax = torch.abs(i)
    ay = torch.abs(q)
    mx = torch.maximum(ax, ay)
    mn = torch.minimum(ax, ay)
    pos = mx > 0
    r = torch.where(pos, mn / torch.where(pos, mx, torch.ones_like(mx)),
                    torch.zeros_like(mx))
    u = r * r
    p = torch.full_like(u, ATAN_COEFFS_F32[-1])
    for c in ATAN_COEFFS_F32[-2::-1]:
        p = p * u + c
    t = r * p
    t = torch.where(ay > ax, HALF_PI_F32 - t, t)
    t = torch.where(i < 0, PI_F32 - t, t)
    return torch.where(q < 0, -t, t)


@lru_cache(maxsize=None)
def trig16_table() -> np.ndarray:
    """The 65536-entry complex exp table of the reference (math.h:95-111)
    as float32 [65536, 2]: entry a is (cos, sin) of a*2*pi/65536 with the
    angle quantized to float32 first, as the reference's cosf/sinf see it
    (a copy of leansdr_tpu/dsp/math_utils.py:25-37)."""
    af = (np.arange(65536, dtype=np.float64) * (2 * np.pi) / 65536).astype(
        np.float32)
    tab = np.stack([np.cos(af.astype(np.float64)),
                    np.sin(af.astype(np.float64))], axis=-1)
    return tab.astype(np.float32)


def expi_u16(table: torch.Tensor, angle_u16: torch.Tensor) -> torch.Tensor:
    """expi(uint16 a): the (cos, sin) rows of the trig16 table at angles
    already wrapped to [0, 65536). Returns [..., 2] float32."""
    return table[angle_u16.to(torch.int64) & 0xFFFF]


def expi_float(table: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """expi(float a): the reference casts (uint16)(int16)(int32)a
    (math.h:108-110), so the float is truncated toward zero to int32
    first, then wrapped to 16 bits. Returns [..., 2] float32 (cos, sin)."""
    return table[(torch.trunc(a).to(torch.int32) & 0xFFFF).to(torch.int64)]
