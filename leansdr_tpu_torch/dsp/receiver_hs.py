"""The integer fast-QPSK receiver of `--hs` (the counterpart of
leansdr_tpu/dsp/receiver_hs.py; reference fast_qpsk_receiver,
sdr.h:946-1189): u8 IQ in, no AGC, phase-only processing through three
lookup tables (polar 256x256 -> (angle, radius); rect 256 angles x 256
radii -> cu8; sincos 65536 -> cu8), a 16-bit fixed-point PLL
(alpha=0.04*65536, beta=0.0012*256*65536/omega) and an integer modified
Mueller&Muller loop; hard symbols by quadrant. Integer arithmetic but for
mu and mucorr, which stay float as in the reference.

`run_chunks_hs` launches csrc/hs_demod.cu for tensors on a GPU and runs
`run_chunks_hs_ref`, the plain PyTorch version of the same arithmetic,
for tensors on the CPU.
"""

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .. import device as _dev
from ..util import trace
from .cstln import CSTLN_AMP

CHUNK = 128
RLUT_BITS = 8
RLUT_ANGLES = 1 << RLUT_BITS
QUAD_MAP = (0, 2, 3, 1)          # symbol of each quadrant of the angle
# The sincos indices the loop can reach: ((arg & 0xC000) + 8192) & 0xFFFF.
SINCOS_AT = tuple(q * 16384 + 8192 for q in range(4))


@lru_cache(maxsize=None)
def _tables_np() -> dict:
    """init_lookup_tables (sdr.h:1146-1170) in NumPy, as the JAX
    hs_tables builds them (int32 entries)."""
    i = np.arange(256)
    re = (i[:, None] - 128).astype(np.float32)
    im = (i[None, :] - 128).astype(np.float32)
    a = np.trunc(np.arctan2(im, re).astype(np.float64) * 65536 / (2 * np.pi))
    lut_a = a.astype(np.int64).astype(np.int16)          # [256,256] s_angle
    lut_r = np.trunc(np.hypot(re, im)).astype(np.int32).astype(np.uint8)

    aa = np.arange(65536)
    f = 2 * np.pi * aa / 65536
    sin_re = np.trunc(128 + CSTLN_AMP * np.cos(f).astype(np.float32)
                      ).astype(np.uint8)
    sin_im = np.trunc(128 + CSTLN_AMP * np.sin(f).astype(np.float32)
                      ).astype(np.uint8)

    ang = np.arange(RLUT_ANGLES)
    r = np.arange(256)
    rect_re = np.trunc(128 + r[None, :] * np.cos(
        2 * np.pi * ang[:, None] / RLUT_ANGLES)).astype(np.int32)
    rect_im = np.trunc(128 + r[None, :] * np.sin(
        2 * np.pi * ang[:, None] / RLUT_ANGLES)).astype(np.int32)
    return {
        "polar_a": lut_a.reshape(-1).astype(np.int32),
        "polar_r": lut_r.reshape(-1).astype(np.int32),
        "rect_re": (rect_re & 0xFF).reshape(-1),
        "rect_im": (rect_im & 0xFF).reshape(-1),
        "sincos_re": sin_re.astype(np.int32),
        "sincos_im": sin_im.astype(np.int32),
    }


# The largest polar radius is trunc(hypot(128, 128)) = 181, so of the rect
# index a * 256 + (r >> 1) only the columns r >> 1 < RECT_COLS are reached.
RECT_COLS = 91


def hs_tables(device) -> dict:
    """The JAX hs_tables on `device` (int32 entries), plus the kernel's
    three: `polar_a16`, the polar angle plane in i16; `polar_w`, the
    polar word of each raw sample index (angle & 0xFFFF | radius << 16,
    int32); `rect16`, the reachable rect entries packed rect_re |
    rect_im << 8 radius-major ([RECT_COLS * 256] u16 bits in int16:
    entry (r >> 1) * 256 + a)."""
    tab = _tables_np()
    t = {k: torch.from_numpy(v).to(device) for k, v in tab.items()}
    t["polar_a16"] = t["polar_a"].to(torch.int16)
    t["polar_w"] = (t["polar_a"] & 0xFFFF) | (t["polar_r"] << 16)
    re = tab["rect_re"].reshape(RLUT_ANGLES, 256)[:, :RECT_COLS]
    im = tab["rect_im"].reshape(RLUT_ANGLES, 256)[:, :RECT_COLS]
    packed = (re | im << 8).T.astype(np.uint16).view(np.int16)
    t["rect16"] = torch.from_numpy(np.ascontiguousarray(packed).reshape(-1)
                                   ).to(device)
    return t


def polar_words(tables: dict, x: torch.Tensor) -> torch.Tensor:
    """The polar word of every sample of x [C, nsamp+1, 2] (u8 IQ values)
    as the kernel reads them: [nsamp+1, C] int32 rows, angle & 0xFFFF |
    radius << 16 (the twin's pa[flat] and pr[flat], gathered in bulk as
    JAX hoists them out of its scan)."""
    flat = ((x[:, :, 0] * 256 + x[:, :, 1]) & 0xFFFF).to(torch.int64)
    return tables["polar_w"][flat].T.contiguous()


@dataclass(frozen=True)
class HsParams:
    omega: float
    pll_adjustment: float = 1.0
    allow_drift: bool = False
    freq0: float = 0.0
    meas_decimation: int = 1 << 20

    @property
    def freq_limits(self):
        # +-SR/8 (update_freq_limits, sdr.h:988-992)
        freqw0 = int(self.freq0 * 65536)
        half = int(65536 / self.omega / 8)
        return freqw0 - half, freqw0 + half


def init_state(params: HsParams, nchan: int, device) -> dict:
    C = nchan
    i32 = dict(dtype=torch.int32, device=device)
    return {
        "mu": torch.zeros(C, dtype=torch.float32, device=device),
        "phase": torch.zeros(C, **i32),
        "freqw": torch.full((C,), int(params.freq0 * 65536), **i32),
        # u8 components of the last three points, [C, 3, 2]
        "hist_p": torch.zeros((C, 3, 2), **i32),
        "hist_c": torch.zeros((C, 3, 2), **i32),
        "meas_count": torch.zeros(C, **i32),
    }


def loop_constants(params: HsParams) -> dict:
    """The loop's constants as the JAX version forms them."""
    lo, hi = params.freq_limits
    return dict(
        omega=float(np.float32(params.omega)),
        gain_mu=float(np.float32(0.02 / (CSTLN_AMP * CSTLN_AMP) * 2)),
        max_mucorr=float(np.float32(0.1)),
        freq_alpha=int(0.04 * 65536),
        freq_beta=int(0.0012 * 256 * 65536 / params.omega
                      * params.pll_adjustment),
        min_freqw=lo, max_freqw=hi, mid_freqw=(lo + hi) // 2,
    )


def _s8(x):
    """(signed char) cast of an int lane."""
    return ((x & 0xFF) ^ 0x80) - 0x80


def _geometry(x: torch.Tensor):
    C, n1, _ = x.shape
    nsamp = n1 - 1
    if nsamp <= 0 or nsamp % CHUNK:
        raise ValueError(f"x has {n1} samples: need a positive multiple of "
                         f"{CHUNK} plus one")
    return C, nsamp, nsamp // CHUNK


def run_chunks_hs_ref(params: HsParams, tables: dict, state: dict,
                      x: torch.Tensor):
    """Plain PyTorch --hs demod over x [C, nsamp+1, 2] int32 (u8 IQ
    values), vectorized over channels, a Python loop over samples.
    Returns (state, dict(symbol [C, nsamp] u8 (every sample's decision),
    valid bool, freq [C, K] float32, nmeas [C, K] int32, sampled
    [C, K, 2] int32 (the chunk's last emitted point), sampled_ok [C, K]
    bool)), as JAX's run_chunks_hs."""
    K_ = loop_constants(params)
    C, nsamp, K = _geometry(x)
    dev = x.device
    pa, pr = tables["polar_a"], tables["polar_r"]
    rre, rim = tables["rect_re"], tables["rect_im"]
    scre, scim = tables["sincos_re"], tables["sincos_im"]
    quad_map = torch.tensor(QUAD_MAP, dtype=torch.int32, device=dev)
    # Polar coordinates of every raw sample (state-independent).
    flat = ((x[:, :, 0] * 256 + x[:, :, 1]) & 0xFFFF).to(torch.int64)
    A, R = pa[flat], pr[flat]
    mu, phase, freqw = (state[k].clone() for k in ("mu", "phase", "freqw"))
    hp = [state["hist_p"][:, k, j] for k in range(3) for j in range(2)]
    hc = [state["hist_c"][:, k, j] for k in range(3) for j in range(2)]
    meas_count = state["meas_count"].clone()
    syms = torch.zeros((C, nsamp), dtype=torch.uint8, device=dev)
    valid = torch.zeros((C, nsamp), dtype=torch.bool, device=dev)
    freq = torch.zeros((C, K), dtype=torch.float32, device=dev)
    nmeas = torch.zeros((C, K), dtype=torch.int32, device=dev)
    sampled = torch.zeros((C, K, 2), dtype=torch.int32, device=dev)
    sampled_ok = torch.zeros((C, K), dtype=torch.bool, device=dev)
    zero = torch.zeros(C, dtype=torch.int32, device=dev)
    for k in range(K):
        l_re = l_im = zero
        l_ok = torch.zeros(C, dtype=torch.bool, device=dev)
        for t in range(CHUNK):
            g = k * CHUNK + t
            p0a, p0r, p1a, p1r = A[:, g], R[:, g], A[:, g + 1], R[:, g + 1]
            emit = mu < 1.0
            a0 = ((p0a - phase) & 0xFFFF) >> (16 - RLUT_BITS)
            r0 = (a0 * 256 + (p0r >> 1)).to(torch.int64)
            a1 = ((p1a - (phase + freqw)) & 0xFFFF) >> (16 - RLUT_BITS)
            r1 = (a1 * 256 + (p1r >> 1)).to(torch.int64)
            p0r_re, p0r_im, p1r_re, p1r_im = rre[r0], rim[r0], rre[r1], \
                rim[r1]
            # s = p0r + (p1r-p0r)*mu: float multiply, truncation, u8 wrap
            s_re = (p0r_re + torch.trunc(
                (p1r_re - p0r_re).to(torch.float32) * mu).to(torch.int32)
            ) & 0xFF
            s_im = (p0r_im + torch.trunc(
                (p1r_im - p0r_im).to(torch.float32) * mu).to(torch.int32)
            ) & 0xFF
            arg = pa[(s_re * 256 + s_im).to(torch.int64)] & 0xFFFF
            quadrant = arg >> 14
            sym = quad_map[quadrant.to(torch.int64)]
            # PLL in 16-bit fixed point (sdr.h:1072-1075)
            pe = (arg & 16383) - 8192
            phase_u = phase + ((pe * K_["freq_alpha"] + 32768) >> 16)
            freqw_u = freqw + ((pe * K_["freq_beta"] + 32768 * 256) >> 24)
            # Integer modified M&M (sdr.h:1099-1108)
            cp_idx = (((arg & 49152) + 8192) & 0xFFFF).to(torch.int64)
            c_re, c_im = scre[cp_idx], scim[cp_idx]
            p0, p0_, p1, p1_ = hp[0], hp[1], hp[2], hp[3]
            q0, q0_, q1, q1_ = hc[0], hc[1], hc[2], hc[3]
            muerr = (_s8(s_re - p1) * (q0 - 128)
                     + _s8(s_im - p1_) * (q0_ - 128)) - \
                (_s8(c_re - q1) * (p0 - 128) + _s8(c_im - q1_) * (p0_ - 128))
            mucorr = torch.clamp(muerr.to(torch.float32) * K_["gain_mu"],
                                 -K_["max_mucorr"], K_["max_mucorr"])
            mu_u = mu + mucorr + K_["omega"]

            def upd(new, old):
                return torch.where(emit, new, old)
            hp = [upd(s_re, hp[0]), upd(s_im, hp[1]), upd(hp[0], hp[2]),
                  upd(hp[1], hp[3]), upd(hp[2], hp[4]), upd(hp[3], hp[5])]
            hc = [upd(c_re, hc[0]), upd(c_im, hc[1]), upd(hc[0], hc[2]),
                  upd(hc[1], hc[3]), upd(hc[2], hc[4]), upd(hc[3], hc[5])]
            mu = upd(mu_u, mu) - 1.0
            freqw = upd(freqw_u, freqw)
            # phase is a u16 angle in the reference: kept wrapped.
            phase = (upd(phase_u, phase) + freqw) & 0xFFFF
            l_re, l_im, l_ok = upd(s_re, l_re), upd(s_im, l_im), l_ok | emit
            syms[:, g] = sym.to(torch.uint8)
            valid[:, g] = emit
        if not params.allow_drift:
            bad = (freqw < K_["min_freqw"]) | (freqw > K_["max_freqw"])
            freqw = torch.where(bad, K_["mid_freqw"], freqw)
        meas_count = meas_count + CHUNK
        nmeas[:, k] = meas_count // params.meas_decimation
        meas_count = meas_count % params.meas_decimation
        freq[:, k] = freqw.to(torch.float32) / 65536
        sampled[:, k, 0], sampled[:, k, 1] = l_re, l_im
        sampled_ok[:, k] = l_ok
    st = {"mu": mu, "phase": phase, "freqw": freqw,
          "hist_p": torch.stack(hp, 1).reshape(C, 3, 2),
          "hist_c": torch.stack(hc, 1).reshape(C, 3, 2),
          "meas_count": meas_count}
    return st, dict(symbol=syms, valid=valid, freq=freq, nmeas=nmeas,
                    sampled=sampled, sampled_ok=sampled_ok)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

class _HsArgs(ctypes.Structure):
    """Mirror of `struct HsArgs` in csrc/hs_demod.cu."""
    _fields_ = [
        ("omega", ctypes.c_float), ("gain_mu", ctypes.c_float),
        ("max_mucorr", ctypes.c_float),
        ("freq_alpha", ctypes.c_int), ("freq_beta", ctypes.c_int),
        ("min_freqw", ctypes.c_int), ("max_freqw", ctypes.c_int),
        ("mid_freqw", ctypes.c_int), ("allow_drift", ctypes.c_int),
        ("meas_decimation", ctypes.c_int),
        ("sc_re", ctypes.c_int * 4), ("sc_im", ctypes.c_int * 4),
    ]


@lru_cache(maxsize=16)
def _hs_args(params: HsParams) -> _HsArgs:
    """The kernel's constants; the sincos table's four reachable entries
    (SINCOS_AT) are read from the table itself."""
    a = _HsArgs(**loop_constants(params))
    a.allow_drift = int(params.allow_drift)
    a.meas_decimation = params.meas_decimation
    tab = _tables_np()
    a.sc_re[:] = [int(tab["sincos_re"][i]) for i in SINCOS_AT]
    a.sc_im[:] = [int(tab["sincos_im"][i]) for i in SINCOS_AT]
    return a


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _dev.load("hs_demod")
        lib.hs_demod_launch.restype = ctypes.c_int
        lib.hs_demod_launch.argtypes = (
            [ctypes.POINTER(_HsArgs)] + [ctypes.c_void_p] * 10
            + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        _lib = lib
    return _lib


def pack_state(state: dict) -> tuple:
    """--hs state dict -> (mu [C] float32, int planes [15, C]: phase,
    freqw, meas_count, hist_p (6), hist_c (6))."""
    hp, hc = state["hist_p"], state["hist_c"]
    rows = [state["phase"], state["freqw"], state["meas_count"]]
    rows += [hp[:, k, j] for k in range(3) for j in range(2)]
    rows += [hc[:, k, j] for k in range(3) for j in range(2)]
    return (state["mu"].to(torch.float32).contiguous(),
            torch.stack([r.to(torch.int32) for r in rows]).contiguous())


def unpack_state(mu: torch.Tensor, ip: torch.Tensor) -> dict:
    def hist(base):
        return torch.stack([ip[base:base + 6:2], ip[base + 1:base + 6:2]],
                           -1).permute(1, 0, 2)
    return {"mu": mu, "phase": ip[0], "freqw": ip[1], "hist_p": hist(3),
            "hist_c": hist(9), "meas_count": ip[2]}


def run_chunks_hs(params: HsParams, tables: dict, state: dict,
                  x: torch.Tensor):
    """Demodulate x [C, nsamp+1, 2] int32 (u8 IQ values) from the --hs
    state dict. Returns (state, outputs) as `run_chunks_hs_ref`.

    CPU tensors run `run_chunks_hs_ref`; CUDA tensors launch
    csrc/hs_demod.cu (one launch for the C channels x K chunks) on the
    samples' polar words (`polar_words`)."""
    if x.device.type == "cpu":
        return run_chunks_hs_ref(params, tables, state, x)
    C, nsamp, K = _geometry(x)
    dev = x.device
    _dev.check_tensor("x", x, torch.int32, (C, nsamp + 1, 2), dev)
    for k, dt, n in (("polar_a16", torch.int16, 65536),
                     ("polar_w", torch.int32, 65536),
                     ("rect16", torch.int16, RECT_COLS * 256)):
        _dev.check_tensor(k, tables[k], dt, (n,), dev)
    pw = polar_words(tables, x)            # [nsamp+1, C]: coalesced rows
    mu, ip = pack_state(state)
    mu_out, ip_out = torch.empty_like(mu), torch.empty_like(ip)
    words = torch.empty((nsamp, C), dtype=torch.int32, device=dev)
    freq = torch.empty((K, C), dtype=torch.float32, device=dev)
    meta = torch.empty((4, K, C), dtype=torch.int32, device=dev)
    with trace.span("kernel.hs_demod"):
        err = _kernel().hs_demod_launch(
            ctypes.byref(_hs_args(params)), tables["polar_a16"].data_ptr(),
            tables["rect16"].data_ptr(), pw.data_ptr(), mu.data_ptr(),
            mu_out.data_ptr(), ip.data_ptr(), ip_out.data_ptr(),
            words.data_ptr(), freq.data_ptr(), meta.data_ptr(), C, nsamp,
            _dev.stream_handle(x))
    _dev.check_launch("hs_demod", err)
    trace.count("launch.hs_demod")
    w = words.T
    return unpack_state(mu_out, ip_out), dict(
        symbol=((w >> 16) & 0xFF).to(torch.uint8),
        valid=((w >> 24) & 1).to(torch.bool), freq=freq.T,
        nmeas=meta[0].T, sampled=meta[1:3].permute(2, 1, 0),
        sampled_ok=meta[3].T.to(torch.bool))
