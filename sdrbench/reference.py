"""The plain reference of the DVB-S receiver's soft layers: the matched
filter, the demod (carrier PLL, Mueller & Muller timing, AGC, computed
QPSK decisions and soft costs, leansdr's sdr.h:700-900 in the arithmetic
of the demod kernel's plain version) and the time-segmented demod engine
(two passes over S segments per carrier, handover cuts, QPSK relabelling
and splice), in NumPy, with the matched filter in plain PyTorch.

It imports nothing of the program. It takes the program's demod state at
a chunk's start (the loops' floats, which only the program's own run up
to that chunk can give) and the benchmark's own capture, and works out
that chunk's symbols, validity and costs and its end state again.

Every float operation rounds once in float32, in the order of the
program's plain version, so where the inputs agree the results agree bit
for bit; the one transcendental the loop uses, cos/sin of a u16 angle,
comes from a 65536-entry table that torch computes on the run's device.

`precision` selects the controls: "fp32" is the reference; "tf32" rounds
the matched filter's inputs to TF32 (10 mantissa bits, float32 sums); "bf16"
rounds every float result of the matched filter and the demod to
bfloat16.
"""

from functools import lru_cache

import numpy as np
import torch

F32 = np.float32
CHUNK = 128                     # samples between the loop's chunk updates
NSTATE = 19
CSTLN_AMP = 75.0
QPSK_A = 53.0
K2PI = float(F32(2 * np.pi / 65536))
K16 = float(F32(65536 / (2 * np.pi)))
SEG_T = 128                     # rows of a segment boundary's overlap
B_HI, B_LO = 0x42FE0000, 0x43000000       # bits of 127.0f and 128.0f


# ----------------------------------------------------------------- precision

def _round_bits(a: np.ndarray, drop: int) -> np.ndarray:
    """float32 -> float32 rounded to nearest even with `drop` low
    mantissa bits cleared."""
    b = np.asarray(a, F32).view(np.uint32).astype(np.uint64)
    half = (1 << (drop - 1)) - 1
    b = (b + half + ((b >> drop) & 1)) & ~np.uint64((1 << drop) - 1)
    return (b & 0xFFFFFFFF).astype(np.uint32).view(F32)


def bf16(a):
    return _round_bits(a, 16)


def tf32(a):
    return _round_bits(a, 13)


def _ident(a):
    return a


# ------------------------------------------------------------------ constants

@lru_cache(maxsize=None)
def atan_coeffs() -> tuple:
    """The polynomial atan's float32 coefficients: the least-squares fit
    of atan(r) / r in powers of r^2, order 7, on 4000 points of (0, 1]."""
    r = np.linspace(0, 1, 4001)[1:]
    u = r * r
    A = np.stack([u ** k for k in range(7)], axis=1) * r[:, None]
    c, *_ = np.linalg.lstsq(A, np.arctan(r), rcond=None)
    return tuple(F32(v) for v in c)


def loop_constants(omega: float, pll_adjustment: float, nsymbols: int = 4,
                   freq0: float = 0.0, kest: float = 0.01) -> dict:
    """The loop's float32 constants from their double formulas
    (sdr.h:700-770)."""
    n = {2: 2, 4: 4, 8: 8, 16: 12, 32: 16}.get(nsymbols, 4)
    half = 65536 / omega / n / 2
    lo, hi = F32(freq0 * 65536 - half), F32(freq0 * 65536 + half)
    return dict(omega=F32(omega), freq_alpha=F32(0.04),
                freq_beta=F32(0.0012 / omega * pll_adjustment),
                gain_mu=F32(0.02 / (CSTLN_AMP * CSTLN_AMP) * 2),
                kest=F32(kest), one_minus_kest=F32(1) - F32(kest),
                min_freqw=lo, max_freqw=hi, mid_freqw=(lo + hi) / F32(2),
                max_mucorr=F32(0.1))


def trig_table(device) -> np.ndarray:
    """[65536, 2] float32: cos and sin of every u16 angle a, as
    float32(a * 2 pi / 65536), by torch on `device`."""
    a = torch.arange(65536, dtype=torch.float32, device=device) * K2PI
    return torch.stack([torch.cos(a), torch.sin(a)], 1).cpu().numpy()


def init_state(nlanes: int, freq0: float = 0.0) -> np.ndarray:
    """The loop's cold state (sdr.h:724-736) as [NSTATE, lanes] planes:
    mu, phase, freqw, agc_gain, est_insp, est_sp, est_ep, then the
    sample and decision histories (re, im of k, k-1, k-2)."""
    st = np.zeros((NSTATE, nlanes), F32)
    st[2] = freq0 * 65536
    st[3] = 1.0
    st[4] = CSTLN_AMP * CSTLN_AMP
    return st


def rrc_taps(order: int, fs: float, rolloff: float) -> np.ndarray:
    """filtergen.h's closed-form RRC, DC-normalised, float32."""
    B = float(rolloff)
    ncoeffs = (order + 1) | 1
    t = np.arange(ncoeffs, dtype=np.float64) - ncoeffs // 2
    tT = t * fs
    den = np.pi * tT * (1 - (4 * B * tT) ** 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        general = np.sqrt(fs) * (np.sin(np.pi * tT * (1 - B))
                                 + 4 * B * tT * np.cos(np.pi * tT * (1 + B))
                                 ) / den
    singular = B * np.sqrt(fs / 2) * (
        (1 + 2 / np.pi) * np.sin(np.pi / (4 * B))
        + (1 - 2 / np.pi) * np.cos(np.pi / (4 * B)))
    c = np.where(den == 0, singular, general)
    c[t == 0] = np.sqrt(fs) * (1 - B + 4 * B / np.pi)
    c = c.astype(F32)
    return (c * F32(1.0 / float(np.sum(c.astype(np.float64))))).astype(F32)


def mf_taps(fs: float, fm: float, rolloff: float, rej: float) -> np.ndarray:
    """The matched filter at the input rate (sdr.h:635-689's RRC sampled
    at Fs rather than at the polyphase rate)."""
    order = int(rej * fs / (22 * (fm / 2) * rolloff))
    return rrc_taps(order, fm / fs, rolloff)


# -------------------------------------------------------------- matched filter

def matched_filter(taps: np.ndarray, freqw: np.ndarray, x: torch.Tensor,
                   precision: str = "fp32") -> torch.Tensor:
    """[lanes, n + ntaps - 1, 2] float32 -> [lanes, n, 2]: derotate by each
    lane's carrier step freqw (u16 units per sample), the real-tap FIR in
    VALID mode as an explicit float32 sum over taps in order, re-rotate
    (sdr.h:676-681's rotated taps, factored out of the sum)."""
    dev = x.device
    rnd = {"bf16": lambda t: _t(bf16, t), "tf32": lambda t: _t(tf32, t)}.get(
        precision, lambda t: t)
    rnd_all = rnd if precision == "bf16" else (lambda t: t)
    c = torch.from_numpy(np.asarray(taps, F32)).to(dev)
    c = rnd(c)
    ntaps = c.shape[0]
    lanes, S, _ = x.shape
    n = S - (ntaps - 1)
    h = ntaps // 2
    fw = torch.from_numpy(np.asarray(freqw, F32)).to(dev)
    s = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    fi = torch.floor(fw)[:, None]
    ff = fw[:, None] - fi
    ph = (((fi.to(torch.int32) * s) & 0xFFFF).to(torch.float32)
          + ff * s.to(torch.float32))
    ang = -K2PI * ph
    dr, di = torch.cos(ang), torch.sin(ang)
    xr, xi = x[:, :, 0], x[:, :, 1]
    ur = rnd_all(rnd_all(xr * dr) - rnd_all(xi * di))
    ui = rnd_all(rnd_all(xr * di) + rnd_all(xi * dr))
    ur, ui = rnd(ur), rnd(ui)
    vr = torch.zeros((lanes, n), dtype=torch.float32, device=dev)
    vi = torch.zeros_like(vr)
    for k in range(ntaps):
        vr = rnd_all(vr + rnd_all(c[k] * ur[:, k:k + n]))
        vi = rnd_all(vi + rnd_all(c[k] * ui[:, k:k + n]))
    ang2 = -ang[:, :n] + K2PI * (torch.remainder(fw[:, None], 65536.0)
                                 * float(h))
    rr, ri = torch.cos(ang2), torch.sin(ang2)
    zr = rnd_all(rnd_all(vr * rr) - rnd_all(vi * ri))
    zi = rnd_all(rnd_all(vr * ri) + rnd_all(vi * rr))
    return torch.stack([zr, zi], dim=-1)


def _t(fn, t: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(fn(t.cpu().numpy())).to(t.device)


# ----------------------------------------------------------------------- demod

def _kceil(v, bref, bound):
    """ceil(log2(v / bound)) for v > bound, from the exponent bits."""
    k = (v.view(np.int32) - bref + 0x7FFFFF) >> 23
    return np.where(v > bound, k, 0)


def _wrap_trunc(v):
    idx = np.trunc(v)
    return idx - np.floor(idx / F32(65536.0)) * F32(65536.0)


def demod(K: dict, trig: np.ndarray, st: np.ndarray, x: np.ndarray,
          precision: str = "fp32"):
    """The demod over x [lanes, n + 1, 2] float32 (n a multiple of CHUNK;
    the extra sample is the linear sampler's lookahead) from the planes
    st [NSTATE, lanes]. Returns (st', sym [n, lanes] uint8, valid [n,
    lanes] bool, cost [n, lanes] int16): per sample, whether a symbol was
    emitted, its QPSK decision and d1 - d2, the squared distances to the
    nearest and second-nearest point on the s8 grid (capped at 32767)."""
    R = bf16 if precision == "bf16" else _ident
    lanes, n1, _ = x.shape
    n = n1 - 1
    if n % CHUNK:
        raise ValueError(f"{n} samples is not a multiple of {CHUNK}")
    xt = np.ascontiguousarray(np.asarray(x, F32).transpose(1, 2, 0))
    cos_t = np.ascontiguousarray(trig[:, 0])
    sin_t = np.ascontiguousarray(trig[:, 1])
    ac = atan_coeffs()
    a = F32(QPSK_A)
    a4 = F32(4 * QPSK_A)
    sym_phase = [np.arctan2(F32(q), F32(i)).astype(F32)
                 for i, q in ((a, a), (a, -a), (-a, a), (-a, -a))]
    pi_f, hpi_f = F32(np.pi), F32(np.pi / 2)
    st = np.array(st, F32, copy=True)
    sym = np.empty((n, lanes), np.uint8)
    valid = np.empty((n, lanes), bool)
    cost_out = np.empty((n, lanes), np.int16)
    one, zero = F32(1), F32(0)
    for ci in range(n // CHUNK):
        (mu, phase, freqw, agc, est_insp, est_sp, est_ep,
         p0r, p0i, p1r, p1i, p2r, p2i,
         c0r, c0i, c1r, c1i, c2r, c2i) = (st[k].copy() for k in range(NSTATE))
        idx_d = _wrap_trunc(-freqw).astype(np.int64)
        dcos, dsin = R(cos_t[idx_d]), R(sin_t[idx_d])
        lsg_re = lsg_im = ls_re = ls_im = lc_re = lc_im = np.zeros(lanes, F32)
        any_sym = np.zeros(lanes, bool)
        for t in range(CHUNK):
            g = ci * CHUNK + t
            x0r, x0i, x1r, x1i = xt[g, 0], xt[g, 1], xt[g + 1, 0], xt[g + 1, 1]
            emit = mu < one
            i0 = _wrap_trunc(-phase).astype(np.int64)
            cr0, sr0 = R(cos_t[i0]), R(sin_t[i0])
            cr1 = R(R(cr0 * dcos) - R(sr0 * dsin))
            sr1 = R(R(sr0 * dcos) + R(cr0 * dsin))
            sg0r = R(R(x0r * cr0) - R(x0i * sr0))
            sg0i = R(R(x0r * sr0) + R(x0i * cr0))
            sg1r = R(R(x1r * cr1) - R(x1i * sr1))
            sg1i = R(R(x1r * sr1) + R(x1i * cr1))
            omu = R(one - mu)
            sgr = R(R(sg0r * omu) + R(sg1r * mu))
            sgi = R(R(sg0i * omu) + R(sg1i * mu))
            sr_ = R(sgr * agc)
            si_ = R(sgi * agc)
            kh = np.maximum(np.maximum(_kceil(sr_, B_HI, 127.0),
                                       _kceil(-sr_, B_LO, 128.0)),
                            np.maximum(_kceil(si_, B_HI, 127.0),
                                       _kceil(-si_, B_LO, 128.0)))
            kh = np.minimum(kh, 12).astype(np.int32)
            scale = ((127 - kh) << 23).astype(np.int32).view(F32)
            i8 = np.trunc(R(sr_ * scale))
            q8 = np.trunc(R(si_ * scale))
            ai, aq = np.abs(i8), np.abs(q8)
            di, dq = R(ai - a), R(aq - a)
            d1 = R(R(di * di) + R(dq * dq))
            d2 = R(d1 + R(a4 * np.minimum(ai, aq)))
            neg_i, neg_q = i8 < zero, q8 < zero
            near = neg_i.astype(np.uint8) * 2 + neg_q.astype(np.uint8)
            cpr = np.where(neg_i, -a, a).astype(F32)
            cpi = np.where(neg_q, -a, a).astype(F32)
            phs = np.where(neg_q, np.where(neg_i, sym_phase[3], sym_phase[1]),
                           np.where(neg_i, sym_phase[2], sym_phase[0]))
            cost = R(np.minimum(d1, F32(32767)) - np.minimum(d2, F32(32767)))
            # atan2(q8, i8), polynomial core (C sign conventions)
            ax, ay = np.abs(i8), np.abs(q8)
            mx, mn = np.maximum(ax, ay), np.minimum(ax, ay)
            pos = mx > zero
            r = np.where(pos, R(mn / np.where(pos, mx, one)), zero)
            u = R(r * r)
            p = np.full(lanes, ac[-1], F32)
            for cf in ac[-2::-1]:
                p = R(R(p * u) + cf)
            at = R(r * p)
            at = np.where(ay > ax, R(hpi_f - at), at)
            at = np.where(i8 < zero, R(pi_f - at), at)
            at = np.where(q8 < zero, -at, at)
            ph_err = R(at - phs)
            pe_i = np.trunc(R(ph_err * F32(K16))).astype(np.int32)
            perr = (((pe_i & 0xFFFF) ^ 0x8000) - 0x8000).astype(F32)
            phase_u = R(phase + R(perr * K["freq_alpha"]))
            freqw_u = R(freqw + R(perr * K["freq_beta"]))
            muerr = R(R(R(R(sr_ - p1r) * c0r) + R(R(si_ - p1i) * c0i))
                      - R(R(R(cpr - c1r) * p0r) + R(R(cpi - c1i) * p0i)))
            mucorr = np.clip(R(muerr * K["gain_mu"]), -K["max_mucorr"],
                             K["max_mucorr"]).astype(F32)
            mu_u = R(R(mu + mucorr) + K["omega"])
            mu = np.where(emit, mu_u, mu)
            phase = np.where(emit, phase_u, phase)
            freqw = np.where(emit, freqw_u, freqw)
            p2r, p1r, p0r = (np.where(emit, p1r, p2r), np.where(emit, p0r, p1r),
                             np.where(emit, sr_, p0r))
            p2i, p1i, p0i = (np.where(emit, p1i, p2i), np.where(emit, p0i, p1i),
                             np.where(emit, si_, p0i))
            c2r, c1r, c0r = (np.where(emit, c1r, c2r), np.where(emit, c0r, c1r),
                             np.where(emit, cpr, c0r))
            c2i, c1i, c0i = (np.where(emit, c1i, c2i), np.where(emit, c0i, c1i),
                             np.where(emit, cpi, c0i))
            lsg_re = np.where(emit, sgr, lsg_re)
            lsg_im = np.where(emit, sgi, lsg_im)
            ls_re = np.where(emit, sr_, ls_re)
            ls_im = np.where(emit, si_, ls_im)
            lc_re = np.where(emit, cpr, lc_re)
            lc_im = np.where(emit, cpi, lc_im)
            any_sym |= emit
            sym[g], valid[g], cost_out[g] = near, emit, cost.astype(np.int16)
            mu = R(mu - one)
            phase = R(phase + freqw)
        # chunk-end updates (sdr.h:852-898)
        phase = R(phase - R(np.trunc(R(phase / F32(65536.0))) * F32(65536.0)))
        kest, kest1 = K["kest"], K["one_minus_kest"]
        insp = R(R(lsg_re * lsg_re) + R(lsg_im * lsg_im))
        est_insp = np.where(any_sym, R(R(insp * kest) + R(est_insp * kest1)),
                            est_insp)
        with np.errstate(divide="ignore", invalid="ignore"):
            gain = R(F32(CSTLN_AMP) / R(np.sqrt(est_insp)))
        agc = np.where(any_sym & (est_insp > zero), gain, agc)
        evr, evi = R(ls_re - lc_re), R(ls_im - lc_im)
        sig_power = R(R(lc_re * lc_re) + R(lc_im * lc_im))
        ev_power = R(R(evr * evr) + R(evi * evi))
        est_sp = np.where(any_sym, R(R(sig_power * kest) + R(est_sp * kest1)),
                          est_sp)
        est_ep = np.where(any_sym, R(R(ev_power * kest) + R(est_ep * kest1)),
                          est_ep)
        bad = (freqw < K["min_freqw"]) | (freqw > K["max_freqw"])
        freqw = np.where(bad, K["mid_freqw"], freqw)
        st = np.stack([mu, phase, freqw, agc, est_insp, est_sp, est_ep,
                       p0r, p0i, p1r, p1i, p2r, p2i,
                       c0r, c0i, c1r, c1i, c2r, c2i]).astype(F32)
    return st, sym, valid, cost_out


# ------------------------------------------------------- the segmented engine

def _wrap_u16(p):
    return (p - np.floor(p / F32(65536.0)) * F32(65536.0)).astype(F32)


def seg_positions(S: int, nseg: int, T: int = SEG_T) -> list:
    """End-of-chunk stream positions of the S persisted segment states,
    relative to the next chunk's head."""
    n = S * nseg
    return [nseg + T - n] + [(j + 1) * nseg - n for j in range(1, S)]


def _rot_label(sb, r):
    """QPSK labels b1b0 = (I negative, Q negative) rotated by r quarter
    turns (r an int or a [lanes] array)."""
    s_ = sb.astype(np.int32)
    forms = (s_, 2 + (s_ >> 1) - 2 * (s_ & 1), 3 - s_,
             1 - (s_ >> 1) + 2 * (s_ & 1))
    if isinstance(r, (int, np.integer)):
        return forms[int(r)].astype(np.uint8)
    out = forms[0]
    for k in (1, 2, 3):
        out = np.where(r[None, :] == k, forms[k], out)
    return out.astype(np.uint8)


class Demod:
    """The reference receiver's soft layers for one configuration."""

    def __init__(self, fs, fm, rolloff, rrc_rej, pll_adjustment, device,
                 precision="fp32"):
        self.K = loop_constants(fs / fm, pll_adjustment)
        self.taps = mf_taps(fs, fm, rolloff, rrc_rej)
        self.trig = trig_table(device)
        self.device = device
        self.precision = precision

    @property
    def readahead(self) -> int:
        return 1 + len(self.taps) - 1

    def run(self, st: np.ndarray, x: torch.Tensor):
        """Matched filter at each lane's freqw, then the demod: x [lanes,
        n + readahead, 2]."""
        z = matched_filter(self.taps, st[2], x.to(self.device),
                           self.precision)
        return demod(self.K, self.trig, st, z.cpu().numpy(), self.precision)

    def segmented(self, S: int, W: int, dem_state: np.ndarray,
                  seg_state: np.ndarray, x: torch.Tensor):
        """One chunk of the time-segmented demod over C carriers: S
        segments per carrier (lane s * C + c), pass 1 over W-sample
        precursor windows seeded from the persisted segment states, pass 2
        over the emit windows, then the handover cuts, the relabelling and
        the splice. dem_state [NSTATE, C], seg_state [NSTATE, S * C], x
        [C, n + readahead, 2]. Returns (dem_state', seg_state', sym [n, C],
        valid, cost)."""
        C = dem_state.shape[1]
        T = SEG_T
        ra = self.readahead
        n = x.shape[1] - ra
        nseg = n // S
        L2 = nseg + T
        pos = seg_positions(S, nseg, T)
        b = [(j + 1) * nseg - T - W for j in range(S - 1)]
        gap = np.repeat(np.array([b[j] - pos[j] for j in range(S - 1)], F32),
                        C)
        xs1 = torch.cat([x[:, bj:bj + W + ra] for bj in b])
        offs2 = [0] + [s * nseg - T for s in range(1, S)]
        xs2 = torch.cat([x[:, o:o + L2 + ra] for o in offs2])
        p1 = seg_state[:, :(S - 1) * C].copy()
        adv = _wrap_u16(_wrap_u16(p1[2] * F32(128.0)) * (gap / F32(128.0)))
        p1[1] = _wrap_u16(p1[1] + adv)
        st1 = self.run(p1, xs1)[0]
        p2 = np.concatenate([dem_state, st1], axis=1)
        seg_out, sym, valid, cost = self.run(p2, xs2)

        def seg_of(a, s):
            return a[:, s * C:(s + 1) * C]

        def owned(s):
            lo = 0 if s == 0 else T
            return lo, lo + nseg

        def tail(s):
            return (nseg - T, nseg) if s == 0 else (nseg, L2)

        dphase = np.array([0.0, 16384.0, 32768.0, -16384.0], F32)
        sym_corr = [seg_of(sym, 0)]
        masks = []
        seg_rot = [np.zeros(C, F32)]
        rows = np.arange(T)[:, None]
        for s in range(1, S):
            ta, tb = tail(s - 1)
            va = seg_of(valid, s - 1)[ta:tb]
            sa = sym_corr[s - 1][ta:tb]
            vb = seg_of(valid, s)[:T]
            sb_raw = seg_of(sym, s)
            cnt = []
            for r in range(4):
                sbr = _rot_label(sb_raw[:T], r)
                m = ((va[:-1] & vb[:-1] & (sa[:-1] == sbr[:-1]))
                     | (va[:-1] & vb[1:] & (sa[:-1] == sbr[1:]))
                     | (va[1:] & vb[:-1] & (sa[1:] == sbr[:-1])))
                cnt.append(m.sum(axis=0))
            cnt = np.stack(cnt)
            rhat = np.argmax(cnt, axis=0)
            rhat = np.where(cnt.max(axis=0) >= T // 8, rhat, 0)
            sseg = _rot_label(sb_raw, rhat)
            seg_rot.append(dphase[rhat])
            sym_corr.append(sseg)
            sb = sseg[:T]
            c0 = va[:-1] & vb[:-1] & (sa[:-1] == sb[:-1])
            c1 = va[:-1] & vb[1:] & (sa[:-1] == sb[1:]) & ~va[1:]
            c2 = va[1:] & vb[:-1] & (sa[1:] == sb[:-1]) & ~vb[1:]
            anyc = c0 | c1 | c2
            first = np.argmax(anyc, axis=0)
            same_row = c0[first, np.arange(C)]
            cut = np.where(same_row, first + 1, first + 2)
            cut = np.where(anyc.any(axis=0), cut, T)
            masks.append(rows >= cut[None, :])
        seg_out = seg_out.copy()
        seg_out[1] = _wrap_u16(seg_out[1] - np.concatenate(seg_rot))
        dem_state = seg_out[:, (S - 1) * C:].copy()

        def splice(a, segs=None):
            get = segs.__getitem__ if segs else (lambda s: seg_of(a, s))
            out = np.concatenate([get(s)[slice(*owned(s))] for s in range(S)])
            for s in range(1, S):
                ta, tb = tail(s - 1)
                out[s * nseg - T:s * nseg] = np.where(
                    masks[s - 1], get(s)[:T], get(s - 1)[ta:tb])
            return out

        return (dem_state, seg_out, splice(sym, sym_corr), splice(valid),
                splice(cost))


# ---------------------------------------------------------------- sample input

# Each format's type and the value that stands for zero (leandvb's input
# stage: u8 offset by 128, s16 and f32 as they are, no scaling).
IQ_FORMATS = {"u8": (np.uint8, 128.0), "s16": (np.int16, 0.0),
              "f32": (np.float32, 0.0)}


def decode_iq(raw: bytes, fmt: str) -> np.ndarray:
    """Raw interleaved I, Q samples -> [n, 2] float32."""
    dtype, zero = IQ_FORMATS[fmt]
    a = np.frombuffer(raw, dtype).astype(F32) - F32(zero)
    return a.reshape(-1, 2)


# ----------------------------------------------------------------- auto-notch

class Notch:
    """leansdr's auto_notch (sdr.h:46-154) on one stream: every
    `decimation` samples a 4096-point FFT of the current block picks the
    `nslots` strongest bins (zeroing each pick's neighbours); per sample
    a first-order tracker y = (1 - k) y + k bb follows each tone (bb the
    input turned down by the slot's bin) and the tones are subtracted;
    the block's gain stays 1 without an AGC set-point. Float32 but for
    the trackers, which run in float64 (scipy's lfilter); the tones'
    cos and sin by torch on `device`.

    The state (slots, trackers, gain, the phase of the detection cadence)
    starts cold or from a snapshot of the program's notch."""

    NFFT = 4096

    def __init__(self, nslots: int, device, state=None,
                 decimation: int = 1024 * 4096, k: float = 0.002):
        self.device = device
        self.decimation = decimation
        self.k = k
        if state is None:
            self.slot = np.full(nslots, -1, np.int64)
            self.estim = np.zeros((nslots, 2), F32)
            self.gain = F32(1)
            self.phase = 0
        else:
            self.slot, self.estim, self.gain, self.phase = (
                np.array(state[0], np.int64), np.array(state[1], F32),
                F32(state[2]), int(state[3]))

    def _run(self, x: np.ndarray) -> np.ndarray:
        from scipy.signal import lfilter
        m = x.shape[0]
        t = torch.from_numpy((np.arange(m) % self.NFFT).astype(F32)).to(
            self.device)
        sl = torch.from_numpy(self.slot.astype(F32)).to(self.device)
        ang = (2 * np.pi / self.NFFT) * sl[:, None] * t[None, :]
        ejr = torch.cos(ang).cpu().numpy()
        eji = torch.sin(ang).cpu().numpy()
        xr, xi = x[None, :, 0], x[None, :, 1]
        br = xr * ejr + xi * eji
        bi = xi * ejr - xr * eji
        a = 1 - self.k
        ys = []
        for b, e in ((br, self.estim[:, 0]), (bi, self.estim[:, 1])):
            u = (F32(self.k) * b).astype(np.float64)
            y = np.stack([lfilter([1.0], [1.0, -a], u[s],
                                  zi=[a * float(e[s])])[0]
                          for s in range(len(self.slot))])
            ys.append(y.astype(F32))
        yr, yi = ys
        active = (self.slot >= 0).astype(F32)[:, None]
        sub_r = np.sum(active * (yr * ejr - yi * eji), axis=0, dtype=F32)
        sub_i = np.sum(active * (yr * eji + yi * ejr), axis=0, dtype=F32)
        self.estim = np.stack([yr[:, -1], yi[:, -1]], -1)
        return (np.stack([x[:, 0] - sub_r, x[:, 1] - sub_i], -1)
                * self.gain).astype(F32)

    def _detect(self, block: np.ndarray):
        z = torch.from_numpy(np.ascontiguousarray(block)).to(self.device)
        y = torch.fft.fft(torch.complex(z[:, 0], z[:, 1]))
        amp = (y.real * y.real + y.imag * y.imag).sqrt().cpu().numpy()
        for s in range(len(self.slot)):
            i = int(amp.argmax())
            if i != self.slot[s]:
                self.estim[s] = 0
            self.slot[s] = i
            amp[max(i - 1, 0):i + 2] = 0

    def process(self, x: np.ndarray) -> np.ndarray:
        """x [n, 2] float32, n a multiple of 4096 -> the notched stream."""
        nb = x.shape[0] // self.NFFT
        outs, start = [], 0
        for b in range(nb):
            self.phase += self.NFFT
            if self.phase >= self.decimation:
                self.phase -= self.decimation
                if b > start:
                    outs.append(self._run(x[start * self.NFFT:b * self.NFFT]))
                start = b
                self._detect(x[b * self.NFFT:(b + 1) * self.NFFT])
        outs.append(self._run(x[start * self.NFFT:nb * self.NFFT]))
        return np.concatenate(outs)


# --------------------------------------------------- hard-decision back half

_POP2 = np.array([0, 1, 1, 2])


def viterbi_hard(labels: np.ndarray) -> tuple:
    """Hard-decision Viterbi of the rate-1/2 K=7 code over QPSK labels
    (G1=0171 gives the label's high bit, G2=0133 its low bit). As the
    encoder's 16-bit register shifting right, the output at bit t reads
    the 7-bit window of bits t-15 .. t-9 (window bit j = bit t-15+j);
    the state is the window's upper 6 bits. Returns (bits, the best
    path's Hamming distance), the bits in the code's order."""
    w = np.arange(128)

    def parity(poly):
        acc = np.zeros(128, np.int64)
        for j in range(7):
            if (poly >> j) & 1:
                acc ^= (w >> j) & 1
        return acc
    label = parity(0o171) * 2 + parity(0o133)
    metric = np.zeros(64)
    back = np.zeros((len(labels), 64), np.int8)
    rows = np.arange(64)
    for t, lab in enumerate(labels):
        # windows 2m and 2m+1 both lead to state m (= window >> 1)
        cost = (metric[w & 63] + _POP2[label ^ lab]).reshape(64, 2)
        pick = np.argmin(cost, axis=1)
        metric = cost[rows, pick]
        back[t] = pick
    s = int(np.argmin(metric))
    best = float(metric[s])
    bits = np.zeros(len(labels), np.uint8)
    for t in range(len(labels) - 1, -1, -1):
        win = 2 * s + int(back[t, s])
        bits[t] = win >> 6
        s = win & 63
    return bits, best


def _swap_iq(labels):
    return ((labels & 1) << 1) | (labels >> 1)


def ts_from_symbols(labels: np.ndarray, prbs: np.ndarray,
                    rs_encode) -> np.ndarray:
    """The plain hard-decision back half over a QPSK label stream: the
    Viterbi decode under each of the 8 phase ambiguities (4 rotations,
    I and Q swapped or not), the one with the least distance kept; the
    byte and polarity alignment on the sync bytes every 204 bytes;
    deinterleave (I=12, M=17); RS(204,188) checked by encoding again;
    derandomized from the first inverted sync. Returns the [k, 188]
    packets that pass, in order."""
    best = None
    for swap in (False, True):
        for r in range(4):
            lab = _rot_label(labels, r).astype(np.int64)
            lab = _swap_iq(lab) if swap else lab
            bits, d = viterbi_hard(lab)
            if best is None or d < best[1]:
                best = (bits, d)
    bits = best[0]
    found = None
    for pol in (0, 1):
        for off in range(8):
            by = np.packbits(bits[off:off + (len(bits) - off) // 8 * 8] ^ pol)
            for b0 in range(204):
                sy = by[b0::204]
                if len(sy) >= 16 and np.isin(sy, (0x47, 0xB8)).mean() > 0.9:
                    found = by[b0:]
                    break
            if found is not None:
                break
        if found is not None:
            break
    if found is None:
        return np.zeros((0, 188), np.uint8)
    depth = 17 * 11 * 12
    i = np.arange(204)
    delay = (17 * 11 - 17 * (i % 12)) % (17 * 12)
    npk = (len(found) - depth) // 204
    idx = depth + np.arange(npk)[:, None] * 204 + i[None, :] - delay * 12
    pk = found[idx]
    ok = (rs_encode(pk[:, :188]) == pk).all(axis=1)
    msgs = pk[ok, :188]
    inv = np.flatnonzero(msgs[:, 0] == 0xB8)
    if not len(inv):
        return np.zeros((0, 188), np.uint8)
    msgs = msgs[inv[0]:]
    pat = prbs.reshape(8, 188)
    return msgs ^ pat[np.arange(len(msgs)) % 8]


# ----------------------------------------------- the algebraic deconvolver

DECONV_TRACEBACK = 64


def _par(x: int) -> int:
    return bin(x).count("1") & 1


@lru_cache(maxsize=None)
def deconv_polynomial() -> int:
    """leansdr's deconvol_sync polynomial for rate 1/2 (dvb.h:165-293):
    the least d such that the parity of d over the code's response to
    input bit i is 1 for i = 0 and 0 for every other i < 64, found by the
    same branch-and-bound search (a frozen copy of its arithmetic)."""
    def convolve(s):
        iq, state = 0, 0
        for b in range(s.bit_length() - 1, -1, -1):
            state = (state >> 1) | (((s >> b) & 1) << 6)
            iq = (iq << 1) | _par(state & 0o171)
            iq = (iq << 1) | _par(state & 0o133)
        return iq
    response = [convolve(1 << i) for i in range(64)]
    best = [(1 << 64) - 1]

    def solve(prefix, n):
        if prefix > best[0] or n > 64:
            return
        solved = True
        for b in range(64):
            if _par(prefix & response[b]) != (1 if b == 0 else 0):
                if (response[b] >> n) == 0:
                    return
                solved = False
        if solved:
            best[0] = prefix
            return
        solve(prefix, n + 1)
        solve(prefix | (1 << n), n + 1)
    solve(0, 0)
    return best[0]


# Symbol -> IQ bits under each of deconvol_sync's 4 sync hypotheses
# (dvb.h:308-360): direct 0, direct 90, conjugate 0, conjugate 90, for
# the symbol (re >= 0) << 1 | (im >= 0) written as in leansdr.
def _sync_maps() -> np.ndarray:
    maps = np.zeros((4, 4), np.uint8)
    for sid in range(4):
        for rp in (0, 1):
            for ip in (0, 1):
                I, Q = [((1 - rp), (1 - ip)), ((1 - ip), rp),
                        ((1 - rp), ip), (ip, rp)][sid]
                maps[sid, (rp << 1) | ip] = (I << 1) | Q
    return maps


def deconvolve(backlog: np.ndarray, locked: int) -> tuple:
    """One block of leansdr's hard deconvolver (deconvol_sync's readbyte
    loop, rate 1/2, no fastlock): the symbols as IQ bit pairs under sync
    hypothesis `locked`; output bit p is the parity of the polynomial
    over the bits that end at TRACEBACK + 2p; whole bytes only, and
    none under 32. Returns (bytes, symbols consumed)."""
    d = deconv_polynomial()
    taps = [j for j in range(64) if (d >> j) & 1]
    iq = _sync_maps()[locked][backlog]
    bits = np.empty(2 * len(backlog), np.uint8)
    bits[0::2] = (iq >> 1) & 1
    bits[1::2] = iq & 1
    if len(bits) < DECONV_TRACEBACK:
        return np.zeros(0, np.uint8), 0
    P = (len(bits) - DECONV_TRACEBACK) // 2 + 1
    P = P // 8 * 8
    if P // 8 < 32:
        return np.zeros(0, np.uint8), 0
    e = DECONV_TRACEBACK + 2 * np.arange(P)
    acc = np.zeros(P, np.uint8)
    for j in taps:
        acc ^= bits[e - 1 - j]
    return np.packbits(acc), P
