"""The demod kernel: carrier PLL + Mueller&Muller timing + soft demap,
one sequential recurrence per channel (the counterpart of
leansdr_tpu/dsp/receiver_pallas.py).

`demod(params, sym_consts, planes, x)` launches the CUDA kernel
(csrc/demod.cu) for tensors on a GPU and runs `demod_ref`, the plain
PyTorch version of the same arithmetic, for tensors on the CPU. A CUDA
tensor always goes to the kernel.

State is NSTATE = 19 float32 planes of [C] (no lane padding):
  0 mu, 1 phase, 2 freqw, 3 agc_gain, 4 est_insp, 5 est_sp, 6 est_ep,
  7..12  hist_p re/im for k, k-1, k-2 (re0,im0,re1,im1,re2,im2)
  13..18 hist_c likewise.

Output is one packed int32 per sample per channel, [nsamp, C]:
  bits 0..15 = -cost (0..32767), bits 16..23 = symbol, bit 24 = valid.

The decision is the gather-free computed form of the reference's
256x256 LUT (integer squared distances over the s8-quantized grid), the
out-of-range halving count comes from the float's exponent bits, and the
phase error is the polynomial atan2 of math_utils. For QPSK the kernel
looks the phase error up instead, in a 256 x 256 int16 table over the
s8 grid that the card fills once per constellation from the same
arithmetic (`pe16_table_ref` is its plain version, `pe16_lookup_ref`
the lookup with its off-grid fallback).
"""

import ctypes
from functools import lru_cache

import numpy as np
import torch

from .. import device as _dev
from ..util import trace
from .cstln import CSTLN_AMP, Cstln
from .math_utils import ATAN_COEFFS_F32, atan2_poly
from .receiver import CHUNK, NSTATE, ReceiverParams, pack_planes, \
    unpack_planes

_F32 = np.float32
K2PI = float(_F32(2 * np.pi / 65536))          # u16 angle -> radians
K16 = float(_F32(65536 / (2 * np.pi)))         # radians -> u16 angle
B_HI = 0x42FE0000                              # bits(127.0f)
B_LO = 0x43000000                              # bits(128.0f)


def sym_constants(cstln: Cstln):
    """Constellation constants baked into the demod: (re, im, phase)
    tuples of float32 values."""
    sym = cstln.symbols.astype(np.float32)
    phase = np.arctan2(sym[:, 1], sym[:, 0]).astype(np.float32)
    return (tuple(float(v) for v in sym[:, 0]),
            tuple(float(v) for v in sym[:, 1]),
            tuple(float(v) for v in phase))


def loop_constants(params: ReceiverParams) -> dict:
    """The loop's float32 constants, each rounded once from its double
    formula as the JAX kernel rounds them."""
    kest = _F32(params.kest)
    lo, hi = (_F32(v) for v in params.freq_limits)
    return dict(
        omega=float(_F32(params.omega)),
        freq_alpha=float(_F32(0.04)),
        freq_beta=float(_F32(0.0012 / params.omega * params.pll_adjustment)),
        gain_mu=float(_F32(0.02 / (CSTLN_AMP * CSTLN_AMP) * 2)),
        kest=float(kest),
        one_minus_kest=float(_F32(1) - kest),
        min_freqw=float(lo),
        max_freqw=float(hi),
        mid_freqw=float((lo + hi) / _F32(2)),
        max_mucorr=float(_F32(0.1)),
        sig_scale=float(_F32(0.707)),
    )


def is_qpsk_grid(sym_re, sym_im) -> bool:
    """The QPSK sign-quadrant grid, whose 4-way argmin has a closed form
    (symbol order 0:(+,+) 1:(+,-) 2:(-,+) 3:(-,-))."""
    return (len(sym_re) == 4
            and len({abs(v) for v in sym_re} | {abs(v) for v in sym_im}) == 1
            and [(v > 0, w > 0) for v, w in zip(sym_re, sym_im)]
            == [(True, True), (True, False), (False, True), (False, False)])


# Receiver state dict ([C] / [C,3,2] tensors) -> [NSTATE, C] planes.
pack_state = pack_planes


def unpack_state(planes: torch.Tensor) -> dict:
    """[NSTATE, C] planes -> receiver state dict."""
    return unpack_planes(planes) | {
        "meas_count": torch.zeros(planes.shape[1], dtype=torch.int32,
                                  device=planes.device)}


def _wrap_trunc(v):
    """expi(float a): truncate toward zero FIRST, then wrap mod 65536
    (math.h:108-110 casts (uint16)(int16)(int32)a)."""
    idx = torch.trunc(v)
    return idx - torch.floor(idx / 65536.0) * 65536.0


def _kceil(v, bref, bound):
    """ceil(log2(v / bound)) for v > bound, from the exponent bits."""
    b = v.view(torch.int32)
    k = (b - bref + 0x7FFFFF) >> 23
    return torch.where(v > bound, k, torch.zeros_like(k))


def quantize_s8(s_re, s_im):
    """(i8, q8): the s8 grid point of the AGC'd sample, as float32
    integers. Out-of-range samples are halved (sdr.h:470-485) by one
    exact power of 2, at most 2^12, so (i8, q8) lies in [-128, 127]^2
    unless that cap binds or the sample is NaN."""
    k_half = torch.maximum(
        torch.maximum(_kceil(s_re, B_HI, 127.0), _kceil(-s_re, B_LO, 128.0)),
        torch.maximum(_kceil(s_im, B_HI, 127.0), _kceil(-s_im, B_LO, 128.0)))
    k_half = torch.clamp(k_half, max=12)
    scale = ((127 - k_half) << 23).view(torch.float32)
    return torch.trunc(s_re * scale), torch.trunc(s_im * scale)


def qpsk_phase(neg_i, neg_q, phases):
    """The phase of the QPSK symbol that the signs of (i8, q8) choose
    (neg_i = i8 < 0, neg_q = q8 < 0; symbol order of is_qpsk_grid;
    phases: four float32 0-d or [C] tensors)."""
    return torch.where(neg_q, torch.where(neg_i, phases[3], phases[1]),
                       torch.where(neg_i, phases[2], phases[0]))


def pe16_ref(i8, q8, ph_sym):
    """The phase error of the decision at (i8, q8) against the symbol
    phase ph_sym: atan2_poly less ph_sym in u16 angle units, truncated,
    sign-folded to int16 (int32 tensor)."""
    ph_err = atan2_poly(q8, i8) - ph_sym
    pe_i = torch.trunc(ph_err * K16).to(torch.int32)
    return ((pe_i & 0xFFFF) ^ 0x8000) - 0x8000


PE_GRID = 256                        # i8, q8 in [-128, 127]


def pe16_table_ref(phases) -> torch.Tensor:
    """The QPSK phase-error table the kernel looks pe16 up in: int16
    [65536], entry (i8 + 128) * 256 + (q8 + 128) = pe16_ref at every grid
    point against the phase its signs choose (phases: the four QPSK
    symbol phases, float32 values)."""
    g = torch.arange(-128, 128, dtype=torch.float32)
    i8, q8 = g.repeat_interleave(PE_GRID), g.repeat(PE_GRID)
    ph = [torch.tensor(v, dtype=torch.float32) for v in phases[:4]]
    return pe16_ref(i8, q8, qpsk_phase(i8 < 0, q8 < 0, ph)).to(torch.int16)


def pe16_lookup_ref(table, i8, q8, ph_sym):
    """pe16 as the kernel's table instance takes it: from `table`
    (pe16_table_ref) where (i8, q8) lies on the grid, from pe16_ref off
    it (the halving cap binds, or NaN)."""
    on = (i8 >= -128) & (i8 <= 127) & (q8 >= -128) & (q8 <= 127)
    idx = torch.where(on, (i8 + 128) * PE_GRID + (q8 + 128), 0.0)
    return torch.where(on, table[idx.to(torch.int64)].to(torch.int32),
                       pe16_ref(i8, q8, ph_sym))


def demod_ref(params: ReceiverParams, sym_consts, planes: torch.Tensor,
              x: torch.Tensor):
    """Plain PyTorch demod: the kernel's arithmetic, one float32
    operation at a time in the JAX kernel's order.

    planes [NSTATE, C] float32, x [C, nsamp+1, 2] float32 (nsamp a
    multiple of CHUNK; the extra sample is the linear sampler's
    lookahead). Returns (planes' [NSTATE, C], packed [nsamp, C] int32).
    """
    K = loop_constants(params)
    sym_re, sym_im, sym_phase = sym_consts
    nsym = len(sym_re)
    qpsk = is_qpsk_grid(sym_re, sym_im)
    C, n1, _ = x.shape
    nsamp = n1 - 1
    if nsamp % CHUNK:
        raise ValueError(f"nsamp={nsamp} is not a multiple of {CHUNK}")
    dev = x.device
    xt = x.transpose(0, 1)                   # [nsamp+1, C, 2]
    xre, xim = xt[..., 0], xt[..., 1]
    st = planes.clone()
    out = torch.empty((nsamp, C), dtype=torch.int32, device=dev)
    zeros = torch.zeros(C, dtype=torch.float32, device=dev)
    izeros = torch.zeros(C, dtype=torch.int32, device=dev)
    amp = torch.full((C,), CSTLN_AMP, dtype=torch.float32, device=dev)

    def full(v):
        return torch.full((C,), v, dtype=torch.float32, device=dev)

    if qpsk:
        a = sym_re[0]
        pa, na = full(a), full(-a)
    else:
        tabs = [(full(sym_re[s]), full(sym_im[s]), full(sym_phase[s]))
                for s in range(nsym)]
    phs = [full(v) for v in sym_phase]

    for ci in range(nsamp // CHUNK):
        mu, phase, freqw, agc_gain = st[0], st[1], st[2], st[3]
        # pin1's rotation = pin0's advanced by the chunk-constant step.
        a_d = _wrap_trunc(-freqw) * K2PI
        dcos = torch.cos(a_d)
        dsin = torch.sin(a_d)
        (p0r, p0i, p1r, p1i, p2r, p2i,
         c0r, c0i, c1r, c1i, c2r, c2i) = (st[7 + k] for k in range(12))
        lsg_re = lsg_im = ls_re = ls_im = lc_re = lc_im = any_f = zeros
        for t in range(CHUNK):
            g = ci * CHUNK + t
            x0r, x0i, x1r, x1i = xre[g], xim[g], xre[g + 1], xim[g + 1]
            emit = mu < 1.0
            a0 = _wrap_trunc(-phase) * K2PI
            cr0 = torch.cos(a0)
            sr0 = torch.sin(a0)
            cr1 = cr0 * dcos - sr0 * dsin
            sr1 = sr0 * dcos + cr0 * dsin
            sg0_re = x0r * cr0 - x0i * sr0
            sg0_im = x0r * sr0 + x0i * cr0
            sg1_re = x1r * cr1 - x1i * sr1
            sg1_im = x1r * sr1 + x1i * cr1
            omu = 1 - mu
            sg_re = sg0_re * omu + sg1_re * mu
            sg_im = sg0_im * omu + sg1_im * mu
            s_re = sg_re * agc_gain
            s_im = sg_im * agc_gain

            i8, q8 = quantize_s8(s_re, s_im)
            if qpsk:
                ai = torch.abs(i8)
                aq = torch.abs(q8)
                di = ai - a
                dq = aq - a
                d1 = di * di + dq * dq
                d2 = d1 + (4 * a) * torch.minimum(ai, aq)
                neg_i = i8 < 0
                neg_q = q8 < 0
                near = neg_i.to(torch.int32) * 2 + neg_q.to(torch.int32)
                cpt_re = torch.where(neg_i, na, pa)
                cpt_im = torch.where(neg_q, na, pa)
                ph_sym = qpsk_phase(neg_i, neg_q, phs)
            else:
                d1 = full(3.4e38)
                d2 = full(3.4e38)
                near = izeros
                cpt_re = cpt_im = ph_sym = zeros
                for s, (sre, sim, sph) in enumerate(tabs):
                    dr = i8 - sre
                    di = q8 - sim
                    ds = dr * dr + di * di
                    better = ds < d1
                    d2 = torch.where(better, d1, torch.minimum(d2, ds))
                    d1 = torch.where(better, ds, d1)
                    near = torch.where(better, s, near)
                    cpt_re = torch.where(better, sre, cpt_re)
                    cpt_im = torch.where(better, sim, cpt_im)
                    ph_sym = torch.where(better, sph, ph_sym)
            cost = (torch.clamp(d1, max=32767.0)
                    - torch.clamp(d2, max=32767.0))

            perr_f = pe16_ref(i8, q8, ph_sym).to(torch.float32)

            # PLL (sdr.h:813-815)
            phase_u = phase + perr_f * K["freq_alpha"]
            freqw_u = freqw + perr_f * K["freq_beta"]
            # modified M&M (sdr.h:817-840)
            muerr = (((s_re - p1r) * c0r + (s_im - p1i) * c0i)
                     - ((cpt_re - c1r) * p0r + (cpt_im - c1i) * p0i))
            mucorr = torch.clamp(muerr * K["gain_mu"], -K["max_mucorr"],
                                 K["max_mucorr"])
            mu_u = mu + mucorr + K["omega"]

            mu = torch.where(emit, mu_u, mu)
            phase = torch.where(emit, phase_u, phase)
            freqw = torch.where(emit, freqw_u, freqw)
            p0r, p1r, p2r = (torch.where(emit, s_re, p0r),
                             torch.where(emit, p0r, p1r),
                             torch.where(emit, p1r, p2r))
            p0i, p1i, p2i = (torch.where(emit, s_im, p0i),
                             torch.where(emit, p0i, p1i),
                             torch.where(emit, p1i, p2i))
            c0r, c1r, c2r = (torch.where(emit, cpt_re, c0r),
                             torch.where(emit, c0r, c1r),
                             torch.where(emit, c1r, c2r))
            c0i, c1i, c2i = (torch.where(emit, cpt_im, c0i),
                             torch.where(emit, c0i, c1i),
                             torch.where(emit, c1i, c2i))
            lsg_re = torch.where(emit, sg_re, lsg_re)
            lsg_im = torch.where(emit, sg_im, lsg_im)
            ls_re = torch.where(emit, s_re, ls_re)
            ls_im = torch.where(emit, s_im, ls_im)
            lc_re = torch.where(emit, cpt_re, lc_re)
            lc_im = torch.where(emit, cpt_im, lc_im)
            any_f = torch.where(emit, 1.0, any_f)

            out[g] = ((-cost).to(torch.int32) | (near << 16)
                      | (emit.to(torch.int32) << 24))
            mu = mu - 1.0
            phase = phase + freqw

        # ---- chunk-end updates (sdr.h:852-898) ----
        any_sym = any_f > 0
        phase = phase - torch.trunc(phase / 65536.0) * 65536.0   # fmodf
        est_insp, est_sp, est_ep = st[4], st[5], st[6]
        kest, kest1 = K["kest"], K["one_minus_kest"]
        insp = lsg_re * lsg_re + lsg_im * lsg_im
        est_insp = torch.where(any_sym, insp * kest + est_insp * kest1,
                               est_insp)
        agc_gain = torch.where(any_sym & (est_insp > 0),
                               amp / torch.sqrt(est_insp), agc_gain)
        ev_re = ls_re - lc_re
        ev_im = ls_im - lc_im
        if params.nsymbols == 2:
            sig_r = (lc_re + lc_im) * K["sig_scale"]
            evr = (ev_re + ev_im) * K["sig_scale"]
            sig_power = sig_r * sig_r
            ev_power = evr * evr
        else:
            sig_power = lc_re * lc_re + lc_im * lc_im
            ev_power = ev_re * ev_re + ev_im * ev_im
        est_sp = torch.where(any_sym, sig_power * kest + est_sp * kest1,
                             est_sp)
        est_ep = torch.where(any_sym, ev_power * kest + est_ep * kest1,
                             est_ep)
        if not params.allow_drift:
            bad = (freqw < K["min_freqw"]) | (freqw > K["max_freqw"])
            freqw = torch.where(bad, K["mid_freqw"], freqw)
        st = torch.stack([mu, phase, freqw, agc_gain, est_insp, est_sp,
                          est_ep, p0r, p0i, p1r, p1i, p2r, p2i,
                          c0r, c0i, c1r, c1i, c2r, c2i])
    return st, out


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

class _DemodArgs(ctypes.Structure):
    """Mirror of `struct DemodArgs` in csrc/demod.cu (passed by value)."""
    _fields_ = [
        ("omega", ctypes.c_float), ("freq_alpha", ctypes.c_float),
        ("freq_beta", ctypes.c_float), ("gain_mu", ctypes.c_float),
        ("kest", ctypes.c_float), ("one_minus_kest", ctypes.c_float),
        ("min_freqw", ctypes.c_float), ("max_freqw", ctypes.c_float),
        ("mid_freqw", ctypes.c_float), ("max_mucorr", ctypes.c_float),
        ("sig_scale", ctypes.c_float),
        ("atan_c", ctypes.c_float * 7),
        ("nsym", ctypes.c_int), ("qpsk", ctypes.c_int),
        ("bpsk_mer", ctypes.c_int), ("allow_drift", ctypes.c_int),
    ]


def _demod_args(params: ReceiverParams, sym_consts) -> _DemodArgs:
    sym_re, sym_im, _ = sym_consts
    a = _DemodArgs(**loop_constants(params))
    a.atan_c[:] = ATAN_COEFFS_F32
    a.nsym = len(sym_re)
    a.qpsk = int(is_qpsk_grid(sym_re, sym_im))
    a.bpsk_mer = int(params.nsymbols == 2)
    a.allow_drift = int(params.allow_drift)
    return a


@lru_cache(maxsize=64)
def _launch_consts(params: ReceiverParams, sym_consts, device):
    """(DemodArgs, sym [3, nsym] float32 on device) for one (params,
    constellation, device), built once: the launch reuses both instead of
    a host-to-device copy per call."""
    sym = torch.tensor(sym_consts, dtype=torch.float32, device=device)
    return _demod_args(params, sym_consts), sym


LANES = 32                           # channels per block of the kernel


def use_pe_table(qpsk: bool, C: int, sms: int) -> bool:
    """Whether a launch takes the kernel's phase-error table: QPSK, and
    its blocks of LANES channels fit on the card's `sms` SMs in one wave
    (the table leaves room for one block per SM, the layout without it
    for two)."""
    return qpsk and -(-C // LANES) <= sms


@lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@lru_cache(maxsize=16)
def _pe_table(phases, device) -> torch.Tensor:
    """The QPSK phase-error table (int16 [65536] on device) for one
    constellation's four symbol phases, filled once on the card by the
    kernel's own arithmetic (pe16_table_ref is its plain version)."""
    args = _DemodArgs()
    args.atan_c[:] = ATAN_COEFFS_F32
    ph = torch.tensor(phases[:4], dtype=torch.float32, device=device)
    table = torch.empty(PE_GRID * PE_GRID, dtype=torch.int16, device=device)
    stream = torch.cuda.current_stream(device)
    err = _kernel().demod_pe_table_launch(ctypes.byref(args), ph.data_ptr(),
                                          table.data_ptr(), stream.cuda_stream)
    _dev.check_launch("demod_pe_table", err)
    stream.synchronize()        # ready for a launch on any stream
    return table


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _dev.load("demod")
        lib.demod_launch.restype = ctypes.c_int
        lib.demod_launch.argtypes = [
            ctypes.POINTER(_DemodArgs), ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.demod_pe_table_launch.restype = ctypes.c_int
        lib.demod_pe_table_launch.argtypes = [
            ctypes.POINTER(_DemodArgs), ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        _lib = lib
    return _lib


def demod(params: ReceiverParams, sym_consts, planes: torch.Tensor,
          x: torch.Tensor):
    """Run the demod over x [C, nsamp+1, 2] float32 from state planes
    [NSTATE, C]. Returns (planes', packed [nsamp, C] int32).

    CPU tensors run `demod_ref`; CUDA tensors launch csrc/demod.cu.
    """
    if x.device.type == "cpu":
        return demod_ref(params, sym_consts, planes, x)
    C, n1, _ = x.shape
    nsamp = n1 - 1
    if nsamp % CHUNK:
        raise ValueError(f"nsamp={nsamp} is not a multiple of {CHUNK}")
    _dev.check_tensor("x", x, torch.float32, (C, n1, 2), x.device)
    _dev.check_tensor("planes", planes, torch.float32, (NSTATE, C),
                      x.device)
    lib = _kernel()
    args, sym = _launch_consts(params, sym_consts, x.device)
    table = (_pe_table(sym_consts[2], x.device)
             if use_pe_table(bool(args.qpsk), C, _sm_count(x.device))
             else None)
    xt = x.transpose(0, 1).contiguous()      # [nsamp+1, C, 2]: coalesced
    st_out = torch.empty_like(planes)
    packed = torch.empty((nsamp, C), dtype=torch.int32, device=x.device)
    with trace.span("kernel.demod"):
        err = lib.demod_launch(ctypes.byref(args), sym.data_ptr(),
                               None if table is None else table.data_ptr(),
                               xt.data_ptr(), planes.data_ptr(),
                               st_out.data_ptr(), packed.data_ptr(), C,
                               nsamp, _dev.stream_handle(x))
    _dev.check_launch("demod", err)
    trace.count("launch.demod")
    if table is not None:
        trace.count("launch.demod.pe_table")
    return st_out, packed
