"""Math primitives of the demod loop (torch), and setup-time NumPy
helpers.

16-bit angle convention of the reference (math.h:95-111, sdr.h:277-278):
65536 = 2*pi.

ATAN_COEFFS are fitted exactly as leansdr_tpu/dsp/math_utils.py fits
them (same least-squares problem, same float values), so the demod's
phase error matches the JAX kernel's.
"""

import numpy as np
import torch


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
