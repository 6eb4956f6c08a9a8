"""The constellation receiver: carrier PLL + Mueller&Muller timing + soft
demap (the counterpart of leansdr_tpu/dsp/receiver.py).

The per-sample recurrence (reference sdr.h:697-938) runs on one of two
routes, each a hand-written CUDA kernel with a plain PyTorch twin:

  * the demod kernel (dsp/receiver_kernel.py, csrc/demod.cu), the
    counterpart of the JAX Pallas kernel: linear sampler, computed
    decisions, state as [19, C] planes;
  * the scan demod (`run_chunks` here, csrc/scan_demod.cu), the
    counterpart of the JAX `lax.scan` (`run_chunks_impl`): the nearest,
    linear or polyphase rrc sampler (fir_sampler, sdr.h:635-689), and
    decisions either from the reference's trig16 table and 256x256 LUT
    (exact_lut=True, bit-exact against the C++ trajectories) or computed
    (exact_lut=False); state as JAX's dict, outputs as JAX's dict.

Constants match Appendix A of SURVEY.md: freq_alpha=0.04,
freq_beta=0.0012/omega*pll_adjustment, gain_mu=0.02/cstln_amp^2*2,
max_mucorr=0.1, kest=0.01, angle convention 65536=2pi.
"""

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .. import device as _dev
from ..util import trace
from .cstln import CSTLN_AMP, Cstln, halve_into_s8, lookup_float
from .math_utils import ATAN_COEFFS_F32, atan2_poly, expi_float, trig16_table

CHUNK = 128      # samples between AGC/MER/clamp updates (sdr.h:706)


@dataclass(frozen=True)
class ReceiverParams:
    """Static configuration of the demod loop."""
    omega: float                 # samples per symbol
    sampler: str = "linear"      # "nearest" | "linear" | "rrc"
    pll_adjustment: float = 1.0
    allow_drift: bool = False
    kest: float = 0.01
    meas_decimation: int = 1 << 20
    nsymbols: int = 4            # for BPSK MER special case + freq limits
    freq0: float = 0.0           # initial freq offset, cycles/sample
    rrc_coeffs: tuple = ()       # fir_sampler taps (sdr.h:635-689)
    rrc_steps: int = 1
    # True = the reference's 256x256 LUT + trig16 table decisions; False =
    # the same decisions computed (the demod kernel's, or the scan's).
    exact_lut: bool = True
    omega_per_channel: bool = False

    @property
    def readahead(self) -> int:
        if self.sampler == "nearest":
            return 0
        if self.sampler == "linear":
            return 1
        return (len(self.rrc_coeffs) - 1) // self.rrc_steps + 1

    @property
    def freq_limits(self) -> tuple:
        # update_freq_limits (sdr.h:755-770)
        n = {2: 2, 4: 4, 8: 8, 16: 12, 32: 16}.get(self.nsymbols, 4)
        freqw0 = self.freq0 * 65536
        half = 65536 / self.omega / n / 2
        return (freqw0 - half, freqw0 + half)


# The state entries of omega_per_channel mode (the candidate scan: one
# symbol rate per channel), in the order of the kernel's [5, C] plane,
# whose fifth row is the clamp's midpoint.
PER_CHANNEL = ("omega", "freq_beta", "min_freqw", "max_freqw")


def per_channel_omega_state(params: ReceiverParams, omegas, device) -> dict:
    """State entries for omega_per_channel mode: one candidate symbol
    rate per channel (freq_beta and the freq limits follow omega), in
    float32 NumPy arithmetic on float32 omegas, as JAX's
    per_channel_omega_state rounds them (not once from double, as
    scan_constants does for the static mode)."""
    omegas = np.asarray(omegas, np.float32)
    n = {2: 2, 4: 4, 8: 8, 16: 12, 32: 16}.get(params.nsymbols, 4)
    freqw0 = params.freq0 * 65536
    half = 65536 / omegas / n / 2
    planes = (omegas,
              (0.0012 / omegas * params.pll_adjustment).astype(np.float32),
              (freqw0 - half).astype(np.float32),
              (freqw0 + half).astype(np.float32))
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in zip(PER_CHANNEL, planes)}


def init_state(params: ReceiverParams, nchan: int, device) -> dict:
    """Initial per-channel loop state (mirrors sdr.h:724-736) as tensors
    on `device`; with the rrc sampler also the fir_sampler's coefficient
    phase and shifted coefficients (rrc_phase 0: the first chunk shifts
    them, sdr.h:640, 667-675); with omega_per_channel the PER_CHANNEL
    entries, every channel at params.omega."""
    C = nchan
    f32 = dict(dtype=torch.float32, device=device)
    extra = {}
    if params.omega_per_channel:
        extra = per_channel_omega_state(
            params, np.full(C, params.omega, np.float32), device)
    if params.sampler == "rrc":
        extra |= {"rrc_phase": torch.zeros(C, dtype=torch.int32,
                                           device=device),
                  "rrc_shifted": torch.zeros((C, len(params.rrc_coeffs), 2),
                                             **f32)}
    return extra | {
        "mu": torch.zeros(C, **f32),
        "phase": torch.zeros(C, **f32),
        "freqw": torch.full((C,), params.freq0 * 65536, **f32),
        "hist_p": torch.zeros((C, 3, 2), **f32),
        "hist_c": torch.zeros((C, 3, 2), **f32),
        "est_insp": torch.full((C,), CSTLN_AMP * CSTLN_AMP, **f32),
        "agc_gain": torch.ones(C, **f32),
        "est_sp": torch.zeros(C, **f32),
        "est_ep": torch.zeros(C, **f32),
        "meas_count": torch.zeros(C, dtype=torch.int32, device=device),
    }


def make_tables(cstln: Cstln, device) -> dict:
    """The scan demod's tables on `device` (the counterpart of JAX's
    make_tables): the trig16 table [65536, 2], the LUT planes (cost i16,
    symbol u8, phase i16, [65536] each), the symbols [nsym, 2] and, for
    the computed decisions, their re, im and phase rows; `sym3` stacks
    those three rows [3, nsym] for the kernel."""
    sym = cstln.symbols.astype(np.float32)
    phase = np.arctan2(sym[:, 1], sym[:, 0]).astype(np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return {
        "trig": t(trig16_table()),
        "lut_cost": t(cstln.lut_cost.astype(np.int16)),
        "lut_symbol": t(cstln.lut_symbol.astype(np.uint8)),
        "lut_phase": t(cstln.lut_phase.astype(np.int16)),
        "symbols": t(sym),
        "sym_re": t(sym[:, 0]),
        "sym_im": t(sym[:, 1]),
        "sym_phase": t(phase),
        "sym3": t(np.stack([sym[:, 0], sym[:, 1], phase])),
    }


_F32 = np.float32
K2PI = float(_F32(2 * np.pi / 65536))          # u16 angle -> radians
TWO_PI = float(_F32(2 * np.pi))


def scan_constants(params: ReceiverParams) -> dict:
    """The scan's float32 constants, each rounded once from its double
    formula as the JAX scan rounds them (the clamp's midpoint is the
    double (lo + hi) / 2, rounded once)."""
    kest = _F32(params.kest)
    lo, hi = params.freq_limits
    return dict(
        omega=float(_F32(params.omega)),
        freq_alpha=float(_F32(0.04)),
        freq_beta=float(_F32(0.0012 / params.omega * params.pll_adjustment)),
        gain_mu=float(_F32(0.02 / (CSTLN_AMP * CSTLN_AMP) * 2)),
        kest=float(kest),
        one_minus_kest=float(_F32(1) - kest),
        min_freqw=float(_F32(lo)),
        max_freqw=float(_F32(hi)),
        mid_freqw=float(_F32((lo + hi) / 2)),
        max_mucorr=float(_F32(0.1)),
        sig_scale=float(_F32(0.707)),
        ln10=float(_F32(np.log(10.0))),
    )


def _rrc(params: ReceiverParams):
    """(ncoeffs, subsampling, taps in the window) of the rrc sampler."""
    nc = len(params.rrc_coeffs)
    sub = params.rrc_steps
    return nc, sub, (nc + sub - 1) // sub


def _geometry(params: ReceiverParams, x: torch.Tensor):
    C, n, _ = x.shape
    nsamp = n - params.readahead
    if nsamp <= 0 or nsamp % CHUNK:
        raise ValueError(f"x has {n} samples: need a positive multiple of "
                         f"{CHUNK} plus the readahead {params.readahead}")
    return C, nsamp, nsamp // CHUNK


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b in IEEE float32 division. A Python scalar divisor would not
    do: PyTorch multiplies by its reciprocal on CUDA (and computes
    scalar / tensor so on the CPU too), which rounds twice."""
    return a / torch.full_like(a, b)


def _expi(exact: bool, trig, a):
    """(cos, sin) of the u16 angle trunc(a) & 0xFFFF: gathered from the
    trig16 table (exact) or computed (torch.cos / torch.sin of the angle
    in radians, as the JAX scan's _expi_computed)."""
    if exact:
        e = expi_float(trig, a)
        return e[..., 0], e[..., 1]
    idx = (torch.trunc(a).to(torch.int32) & 0xFFFF).to(torch.float32)
    ang = idx * K2PI
    return torch.cos(ang), torch.sin(ang)


def _reshift(params, trig, rrc_c, state):
    """The throttled coefficient re-shift at a chunk's start (sdr.h:
    667-682): one update per ncoeffs*16 processed samples, the taps
    turned by the chunk-start freqw / subsampling."""
    nc, sub, _ = _rrc(params)
    ph = state["rrc_phase"] - CHUNK
    do_upd = ph <= 0
    ph = torch.where(do_upd, torch.full_like(ph, nc * 16), ph)
    f = _div(state["freqw"], sub)
    i_c = (torch.arange(nc, dtype=torch.float32, device=f.device)
           - float(nc // 2))
    ec, es = _expi(params.exact_lut, trig, -f[:, None] * i_c[None, :])
    shifted = torch.stack([ec * rrc_c[None, :], es * rrc_c[None, :]], -1)
    state["rrc_shifted"] = torch.where(do_upd[:, None, None], shifted,
                                       state["rrc_shifted"])
    state["rrc_phase"] = ph


def run_chunks_ref(params: ReceiverParams, tables: dict, state: dict,
                   x: torch.Tensor):
    """Plain PyTorch scan demod: the kernel's arithmetic, one float32
    operation at a time in the JAX scan's order, vectorized over
    channels, a Python loop over samples.

    x [C, n, 2] float32 with n = K*CHUNK + params.readahead. Returns
    (state, outputs) as JAX's run_chunks: cost [C, nsamp] i16, symbol u8,
    valid bool (0 words where no symbol was emitted), and per chunk
    sampled [C, K, 2] (the chunk's last emitted AGC'd sample), freq,
    ss, mer [C, K] float32 and nmeas [C, K] int32.
    """
    K_ = scan_constants(params)
    C, nsamp, K = _geometry(params, x)
    dev = x.device
    exact = params.exact_lut
    trig = tables["trig"]
    sym_re, sym_im = tables["sym_re"], tables["sym_im"]
    sym_phase = tables["sym_phase"]
    nsym = sym_re.shape[0]
    rrc = params.sampler == "rrc"
    if rrc:
        nc, sub, ntaps = _rrc(params)
        rrc_c = torch.tensor(params.rrc_coeffs, dtype=torch.float32,
                             device=dev)
        tap_offs = torch.arange(ntaps, device=dev) * sub
    st = {k: v.clone() for k, v in state.items()}
    omega, freq_beta = K_["omega"], K_["freq_beta"]
    min_freqw, max_freqw = K_["min_freqw"], K_["max_freqw"]
    mid_freqw = K_["mid_freqw"]
    if params.omega_per_channel:
        # The JAX scan's per-channel mode: the four state entries, and
        # the clamp's midpoint (min + max) / 2 in float32 from them.
        omega, freq_beta, min_freqw, max_freqw = (
            st[k] for k in PER_CHANNEL)
        mid_freqw = (min_freqw + max_freqw) / 2
    mu, phase, freqw = st["mu"], st["phase"], st["freqw"]
    agc_gain = st["agc_gain"]
    hp = [st["hist_p"][:, k, j] for k in range(3) for j in range(2)]
    hc = [st["hist_c"][:, k, j] for k in range(3) for j in range(2)]
    xre, xim = x[..., 0], x[..., 1]
    zero = torch.zeros(C, dtype=torch.float32, device=dev)
    words = torch.zeros((C, nsamp), dtype=torch.int32, device=dev)
    meta = torch.zeros((5, C, K), dtype=torch.float32, device=dev)
    nmeas = torch.zeros((C, K), dtype=torch.int32, device=dev)
    inf = torch.tensor(float("inf"), device=dev)

    for k in range(K):
        chunk_freqw = freqw
        st["freqw"] = freqw
        if rrc:
            _reshift(params, trig, rrc_c, st)
            sh_re = st["rrc_shifted"][..., 0]
            sh_im = st["rrc_shifted"][..., 1]
        elif params.sampler == "linear" and not exact:
            # The second rotation = the first advanced by the
            # chunk-constant step (the JAX scan's fast path).
            idx_d = torch.trunc(-chunk_freqw)
            idx_d = idx_d - torch.floor(idx_d / 65536.0) * 65536.0
            a_d = idx_d * K2PI
            dc, dsn = torch.cos(a_d), torch.sin(a_d)
        lsg_re = lsg_im = ls_re = ls_im = lc_re = lc_im = zero
        any_sym = torch.zeros(C, dtype=torch.bool, device=dev)
        for t in range(CHUNK):
            g = k * CHUNK + t
            emit = mu < 1.0
            c0, s0 = _expi(exact, trig, -phase)
            if params.sampler == "linear":
                x0r, x0i, x1r, x1i = xre[:, g], xim[:, g], xre[:, g + 1], \
                    xim[:, g + 1]
                sg0_re = x0r * c0 - x0i * s0
                sg0_im = x0r * s0 + x0i * c0
                if exact:
                    c1, s1 = _expi(True, trig, -(phase + chunk_freqw))
                else:
                    c1 = c0 * dc - s0 * dsn
                    s1 = s0 * dc + c0 * dsn
                sg1_re = x1r * c1 - x1i * s1
                sg1_im = x1r * s1 + x1i * c1
                omu = 1.0 - mu
                sg_re = sg0_re * omu + sg1_re * mu
                sg_im = sg0_im * omu + sg1_im * mu
            elif params.sampler == "nearest":
                x0r, x0i = xre[:, g], xim[:, g]
                sg_re = x0r * c0 - x0i * s0
                sg_im = x0r * s0 + x0i * c0
            else:
                # fir_sampler.interp (sdr.h:646-665): the polyphase
                # matched filter at phase (1-mu)*subsampling, stride
                # subsampling, summed in tap order, then one derotation.
                w_re = xre[:, g:g + ntaps]
                w_im = xim[:, g:g + ntaps]
                idx0 = torch.trunc((1.0 - mu) * sub).to(torch.int64)
                pc = idx0[:, None] + tap_offs[None, :]
                okf = (pc < nc).to(torch.float32)
                pcc = pc.clamp(0, nc - 1)     # (non-emitted samples only)
                co_re = torch.gather(sh_re, 1, pcc)
                co_im = torch.gather(sh_im, 1, pcc)
                t_re = okf * (co_re * w_re - co_im * w_im)
                t_im = okf * (co_re * w_im + co_im * w_re)
                acc_re = acc_im = zero
                for j in range(ntaps):
                    acc_re = acc_re + t_re[:, j]
                    acc_im = acc_im + t_im[:, j]
                sg_re = c0 * acc_re - s0 * acc_im
                sg_im = c0 * acc_im + s0 * acc_re
            s_re = sg_re * agc_gain
            s_im = sg_im * agc_gain

            if exact:
                cost, near, perr = lookup_float(
                    tables["lut_cost"], tables["lut_symbol"],
                    tables["lut_phase"], s_re, s_im)
                near = near.to(torch.int64)
                cost = cost.to(torch.int32)
                cpt_re, cpt_im = sym_re[near], sym_im[near]
                perr_f = perr.to(torch.float32)
            else:
                hi, hq = halve_into_s8(s_re, s_im)
                i8, q8 = torch.trunc(hi), torch.trunc(hq)
                d = ((i8[:, None] - sym_re[None, :]) ** 2
                     + (q8[:, None] - sym_im[None, :]) ** 2)
                near = torch.argmin(d, dim=1)
                d1 = d.amin(dim=1)
                d2 = torch.where(
                    torch.arange(nsym, device=dev)[None, :] == near[:, None],
                    inf, d).amin(dim=1)
                cost = (torch.clamp(d1, max=32767.0)
                        - torch.clamp(d2, max=32767.0)).to(torch.int32)
                cpt_re, cpt_im = sym_re[near], sym_im[near]
                ph_err = atan2_poly(q8, i8) - sym_phase[near]
                pe = torch.trunc(_div(ph_err * 65536.0, TWO_PI)).to(
                    torch.int32)
                perr_f = (((pe & 0xFFFF) ^ 0x8000) - 0x8000).to(
                    torch.float32)

            # PLL (sdr.h:813-815)
            phase_u = phase + perr_f * K_["freq_alpha"]
            freqw_u = freqw + perr_f * freq_beta
            # modified M&M (sdr.h:817-840)
            p0r, p0i, p1r, p1i, p2r, p2i = hp
            c0r, c0i, c1r, c1i, c2r, c2i = hc
            muerr = (((s_re - p1r) * c0r + (s_im - p1i) * c0i)
                     - ((cpt_re - c1r) * p0r + (cpt_im - c1i) * p0i))
            mucorr = torch.clamp(muerr * K_["gain_mu"], -K_["max_mucorr"],
                                 K_["max_mucorr"])
            mu_u = mu + mucorr + omega

            def upd(new, old):
                return torch.where(emit, new, old)
            mu, phase, freqw = upd(mu_u, mu), upd(phase_u, phase), \
                upd(freqw_u, freqw)
            hp = [upd(s_re, p0r), upd(s_im, p0i), upd(p0r, p1r),
                  upd(p0i, p1i), upd(p1r, p2r), upd(p1i, p2i)]
            hc = [upd(cpt_re, c0r), upd(cpt_im, c0i), upd(c0r, c1r),
                  upd(c0i, c1i), upd(c1r, c2r), upd(c1i, c2i)]
            lsg_re, lsg_im = upd(sg_re, lsg_re), upd(sg_im, lsg_im)
            ls_re, ls_im = upd(s_re, ls_re), upd(s_im, ls_im)
            lc_re, lc_im = upd(cpt_re, lc_re), upd(cpt_im, lc_im)
            any_sym = any_sym | emit
            words[:, g] = torch.where(
                emit, (-cost) | (near.to(torch.int32) << 16) | (1 << 24), 0)
            mu = mu - 1.0
            phase = phase + freqw

        # ---- end of chunk (sdr.h:852-913) ----
        phase = torch.fmod(phase, 65536.0)
        kest, kest1 = K_["kest"], K_["one_minus_kest"]
        est_insp = torch.where(
            any_sym, (lsg_re * lsg_re + lsg_im * lsg_im) * kest
            + st["est_insp"] * kest1, st["est_insp"])
        agc_gain = torch.where(
            any_sym & (est_insp > 0),
            torch.full_like(est_insp, CSTLN_AMP) / torch.sqrt(est_insp),
            agc_gain)
        ev_re, ev_im = ls_re - lc_re, ls_im - lc_im
        if params.nsymbols == 2:
            sig_r = (lc_re + lc_im) * K_["sig_scale"]
            ev_r = (ev_re + ev_im) * K_["sig_scale"]
            sig_power, ev_power = sig_r * sig_r, ev_r * ev_r
        else:
            sig_power = lc_re * lc_re + lc_im * lc_im
            ev_power = ev_re * ev_re + ev_im * ev_im
        est_sp = torch.where(any_sym, sig_power * kest + st["est_sp"] * kest1,
                             st["est_sp"])
        est_ep = torch.where(any_sym, ev_power * kest + st["est_ep"] * kest1,
                             st["est_ep"])
        if not params.allow_drift:
            bad = (freqw < min_freqw) | (freqw > max_freqw)
            freqw = torch.where(bad, mid_freqw, freqw)
        mc = st["meas_count"] + CHUNK
        nmeas[:, k] = mc // params.meas_decimation
        st["meas_count"] = mc % params.meas_decimation
        st.update(est_insp=est_insp, est_sp=est_sp, est_ep=est_ep)
        meta[0, :, k], meta[1, :, k] = ls_re, ls_im
        meta[2, :, k] = freqw / 65536.0
        meta[3, :, k] = torch.sqrt(est_insp)
        meta[4, :, k] = torch.where(
            est_ep > 0, _div(10.0 * torch.log(est_sp / est_ep), K_["ln10"]),
            0.0)
    st.update(mu=mu, phase=phase, freqw=freqw, agc_gain=agc_gain,
              hist_p=torch.stack(hp, 1).reshape(C, 3, 2),
              hist_c=torch.stack(hc, 1).reshape(C, 3, 2))
    return st, _outputs(words, meta.permute(0, 2, 1), nmeas.T)


def _outputs(words, meta, nmeas):
    """JAX's outputs dict from packed words [C, nsamp] (or [nsamp, C] as
    a transposed view) and meta [5, K, C], nmeas [K, C]."""
    return dict(cost=(-(words & 0xFFFF)).to(torch.int16),
                symbol=((words >> 16) & 0xFF).to(torch.uint8),
                valid=((words >> 24) & 1).to(torch.bool),
                sampled=meta[:2].permute(2, 1, 0), freq=meta[2].T,
                ss=meta[3].T, mer=meta[4].T, nmeas=nmeas.T)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

SAMPLERS = {"nearest": 0, "linear": 1, "rrc": 2}
NSTATE = 19      # float planes: mu, phase, freqw, agc_gain, est_insp,
#                  est_sp, est_ep, hist_p (6), hist_c (6)
SMEM_LIMIT = 232448



class _ScanArgs(ctypes.Structure):
    """Mirror of `struct ScanArgs` in csrc/scan_demod.cu."""
    _fields_ = [
        ("omega", ctypes.c_float), ("freq_alpha", ctypes.c_float),
        ("freq_beta", ctypes.c_float), ("gain_mu", ctypes.c_float),
        ("kest", ctypes.c_float), ("one_minus_kest", ctypes.c_float),
        ("min_freqw", ctypes.c_float), ("max_freqw", ctypes.c_float),
        ("mid_freqw", ctypes.c_float), ("max_mucorr", ctypes.c_float),
        ("sig_scale", ctypes.c_float), ("ln10", ctypes.c_float),
        ("atan_c", ctypes.c_float * 7),
        ("sampler", ctypes.c_int), ("exact", ctypes.c_int),
        ("nsym", ctypes.c_int), ("bpsk_mer", ctypes.c_int),
        ("allow_drift", ctypes.c_int), ("meas_decimation", ctypes.c_int),
        ("ncoeffs", ctypes.c_int), ("sub", ctypes.c_int),
        ("ntaps", ctypes.c_int), ("readahead", ctypes.c_int),
        ("taps_shared", ctypes.c_int),
    ]


def pack_planes(state: dict) -> torch.Tensor:
    """A state dict ([C] / [C,3,2] tensors) -> the [NSTATE, C] float32
    planes both demod kernels take: 0 mu, 1 phase, 2 freqw, 3 agc_gain,
    4 est_insp, 5 est_sp, 6 est_ep, 7..12 hist_p re/im for k, k-1, k-2
    (re0,im0,re1,im1,re2,im2), 13..18 hist_c likewise."""
    hp, hc = state["hist_p"], state["hist_c"]
    rows = [state[k] for k in ("mu", "phase", "freqw", "agc_gain",
                               "est_insp", "est_sp", "est_ep")]
    rows += [hp[:, k, j] for k in range(3) for j in range(2)]
    rows += [hc[:, k, j] for k in range(3) for j in range(2)]
    return torch.stack([r.to(torch.float32) for r in rows]).contiguous()


def unpack_planes(fp: torch.Tensor) -> dict:
    """pack_planes' inverse (the float fields of the state dict)."""
    def hist(base):
        return torch.stack([fp[base:base + 6:2], fp[base + 1:base + 6:2]],
                           -1).permute(1, 0, 2)
    return {"mu": fp[0], "phase": fp[1], "freqw": fp[2], "hist_p": hist(7),
            "hist_c": hist(13), "est_insp": fp[4], "agc_gain": fp[3],
            "est_sp": fp[5], "est_ep": fp[6]}


def pack_state(state: dict) -> tuple:
    """A scan state dict -> (float planes [19, C], int planes [2, C]:
    meas_count and rrc_phase, 0 without rrc)."""
    mc = state["meas_count"]
    ip = torch.stack([mc, state.get("rrc_phase", torch.zeros_like(mc))])
    return pack_planes(state), ip.to(torch.int32).contiguous()


def unpack_state(fp: torch.Tensor, ip: torch.Tensor, shifted=None) -> dict:
    """pack_state's inverse; `shifted` [C, nc, 2] adds the rrc keys."""
    st = {} if shifted is None else {"rrc_phase": ip[1],
                                     "rrc_shifted": shifted}
    return st | unpack_planes(fp) | {"meas_count": ip[0]}


def _scan_args(params: ReceiverParams, nsym: int) -> _ScanArgs:
    a = _ScanArgs(**scan_constants(params))
    a.atan_c[:] = ATAN_COEFFS_F32
    a.sampler = SAMPLERS[params.sampler]
    a.exact = int(params.exact_lut)
    a.nsym = nsym
    a.bpsk_mer = int(params.nsymbols == 2)
    a.allow_drift = int(params.allow_drift)
    a.meas_decimation = params.meas_decimation
    if params.sampler == "rrc":
        a.ncoeffs, a.sub, a.ntaps = _rrc(params)
        a.taps_shared = int(taps_in_shared(params, nsym))
    a.readahead = params.readahead
    return a


def _ring_bytes(params: ReceiverParams, nsym: int) -> int:
    """One channel's two stages of CHUNK + readahead input rows and the
    constellation rows."""
    return 2 * (CHUNK + params.readahead) * 8 + 3 * nsym * 4


def taps_in_shared(params: ReceiverParams, nsym: int) -> bool:
    """Whether the rrc sampler's shifted coefficients (one channel's
    ncoeffs float2) fit in the kernel's shared memory beside the input
    ring: the shared-memory instance of the kernel, else the
    device-memory one (past ~29,000 coefficients; the CLI's geometries
    have 499 and 497)."""
    return (params.sampler == "rrc" and _ring_bytes(params, nsym)
            + len(params.rrc_coeffs) * 8 <= SMEM_LIMIT)


def smem_bytes(params: ReceiverParams, nsym: int) -> int:
    """The kernel's dynamic shared memory (the formula of
    scan_demod_launch): the input ring and constellation rows, plus the
    rrc taps where they fit (`taps_in_shared`)."""
    taps = len(params.rrc_coeffs) * 8 if taps_in_shared(params, nsym) else 0
    return _ring_bytes(params, nsym) + taps


@lru_cache(maxsize=64)
def _launch_consts(params: ReceiverParams, nsym: int, device):
    """(ScanArgs, rrc coefficients on device) for one (params, device)."""
    coeffs = torch.tensor(params.rrc_coeffs or (0.0,), dtype=torch.float32,
                          device=device)
    return _scan_args(params, nsym), coeffs


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _dev.load("scan_demod")
        lib.scan_demod_launch.restype = ctypes.c_int
        lib.scan_demod_launch.argtypes = (
            [ctypes.POINTER(_ScanArgs)] + [ctypes.c_void_p] * 16
            + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        _lib = lib
    return _lib


def run_chunks(params: ReceiverParams, tables: dict, state: dict,
               x: torch.Tensor):
    """Demodulate x [C, n, 2] float32 (n = K*CHUNK + readahead) from the
    scan state dict. Returns (state, outputs) as `run_chunks_ref`.

    CPU tensors run `run_chunks_ref`; CUDA tensors launch
    csrc/scan_demod.cu (one launch for the C channels x K chunks; with
    the rrc sampler its shared-memory instance where the taps fit, else
    its device-memory instance; with omega_per_channel the [5, C] plane
    of the PER_CHANNEL entries and their midpoint, which each block
    loads once into registers)."""
    if x.device.type == "cpu":
        return run_chunks_ref(params, tables, state, x)
    C, nsamp, K = _geometry(params, x)
    dev = x.device
    n = x.shape[1]
    xt = x.transpose(0, 1).contiguous()      # [n, C, 2]: coalesced rows
    _dev.check_tensor("x", xt, torch.float32, (n, C, 2), dev)
    nsym = tables["sym3"].shape[1]
    if smem_bytes(params, nsym) > SMEM_LIMIT:
        raise ValueError(f"readahead {params.readahead}: the staged input "
                         "exceeds the kernel's shared memory")
    for k, dt in (("trig", torch.float32), ("lut_cost", torch.int16),
                  ("lut_symbol", torch.uint8), ("lut_phase", torch.int16),
                  ("sym3", torch.float32)):
        t = tables[k]
        _dev.check_tensor(k, t, dt, t.shape, dev)
    args, coeffs = _launch_consts(params, nsym, dev)
    fp, ip = pack_state(state)
    rrc = params.sampler == "rrc"
    if rrc:
        nc = len(params.rrc_coeffs)
        _dev.check_tensor("rrc_shifted", state["rrc_shifted"].contiguous(),
                          torch.float32, (C, nc, 2), dev)
        # [nc, C, 2], coalesced across the warp; a copy, which the kernel
        # overwrites with the end state (never the caller's tensor).
        shifted = state["rrc_shifted"].transpose(0, 1).clone(
            memory_format=torch.contiguous_format)
    else:
        shifted = torch.empty(0, dtype=torch.float32, device=dev)
    chan = torch.empty(0, dtype=torch.float32, device=dev)
    if params.omega_per_channel:
        mn, mx = state["min_freqw"], state["max_freqw"]
        chan = torch.stack([state[k] for k in PER_CHANNEL]
                           + [(mn + mx) / 2]).contiguous()
        _dev.check_tensor("per-channel omega", chan, torch.float32, (5, C),
                          dev)
    fp_out, ip_out = torch.empty_like(fp), torch.empty_like(ip)
    words = torch.empty((nsamp, C), dtype=torch.int32, device=dev)
    meta = torch.empty((5, K, C), dtype=torch.float32, device=dev)
    nmeas = torch.empty((K, C), dtype=torch.int32, device=dev)
    with trace.span("kernel.scan_demod"):
        err = _kernel().scan_demod_launch(
            ctypes.byref(args), tables["trig"].data_ptr(),
            tables["lut_cost"].data_ptr(), tables["lut_symbol"].data_ptr(),
            tables["lut_phase"].data_ptr(), tables["sym3"].data_ptr(),
            coeffs.data_ptr(), chan.data_ptr() if chan.numel() else None,
            xt.data_ptr(), fp.data_ptr(), fp_out.data_ptr(),
            ip.data_ptr(), ip_out.data_ptr(), shifted.data_ptr(),
            words.data_ptr(), meta.data_ptr(), nmeas.data_ptr(), C, nsamp,
            _dev.stream_handle(x))
    _dev.check_launch("scan_demod", err)
    trace.count("launch.scan_demod")
    if rrc and not args.taps_shared:
        trace.count("launch.scan_demod.device_taps")
    if params.omega_per_channel:
        trace.count("launch.scan_demod.per_channel")
    st = unpack_state(fp_out, ip_out,
                      shifted.transpose(0, 1) if rrc else None)
    if params.omega_per_channel:
        st |= {k: state[k] for k in PER_CHANNEL}
    return st, _outputs(words.T, meta, nmeas)
