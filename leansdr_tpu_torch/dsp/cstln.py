"""Constellations and the 256x256 soft-decision lookup table (a NumPy
copy of leansdr_tpu/dsp/cstln.py; the port imports nothing of that
package).

Re-expresses cstln_lut (reference sdr.h:299-573): symbol tables for
BPSK/QPSK/8PSK/16APSK/32APSK/64APSK-E/QAM{16,64,256}, and the precomputed
per-(I,Q)-cell {cost, nearest symbol, phase_error} grid, built with
vectorized NumPy at setup time.  The demod kernel computes its decisions
in closed form (dsp/receiver_kernel.py); the LUT serves the Viterbi sync
maps (fec/viterbi.make_sync_maps).

The quantization semantics of the reference are kept exactly: symbols are
truncated to signed char after scaling by cstln_amp (sdr.h:492-495), the
cost is nearest-minus-second-nearest squared distance saturated at 32767
(sdr.h:537-553), and the demod kernel halves out-of-range coordinates then
truncates to s8 (sdr.h:479-485).
"""

from dataclasses import dataclass, field
from enum import IntEnum
from functools import lru_cache

import numpy as np

# Target RMS amplitude for AGC (sdr.h:297).
CSTLN_AMP = 75.0


class Predef(IntEnum):
    """Constellation families (sdr.h:305-311)."""
    BPSK = 0
    QPSK = 1
    PSK8 = 2
    APSK16 = 3
    APSK32 = 4
    APSK64E = 5
    QAM16 = 6
    QAM64 = 7
    QAM256 = 8


CSTLN_NAMES = {
    Predef.BPSK: "BPSK", Predef.QPSK: "QPSK", Predef.PSK8: "8PSK",
    Predef.APSK16: "16APSK", Predef.APSK32: "32APSK",
    Predef.APSK64E: "64APSKe", Predef.QAM16: "16QAM",
    Predef.QAM64: "64QAM", Predef.QAM256: "256QAM",
}


def _polar(r: float, n: int, i: float) -> tuple[int, int]:
    """polar(r, n, i) -> s8 IQ point (sdr.h:492-495): angle i*2pi/n,
    scaled by CSTLN_AMP, truncated toward zero."""
    a = i * 2 * np.pi / n
    re = np.float32(r * np.float32(np.cos(a)) * CSTLN_AMP)
    im = np.float32(r * np.float32(np.sin(a)) * CSTLN_AMP)
    return int(np.trunc(re)), int(np.trunc(im))


@dataclass
class Cstln:
    """A constellation: s8 symbol points + soft-decision LUT planes."""
    predef: Predef
    nsymbols: int
    nrotations: int
    symbols: np.ndarray          # [nsymbols, 2] int8 (re, im)
    # 256x256 LUT planes, indexed [(u8)I * 256 + (u8)Q]:
    lut_cost: np.ndarray = field(default=None)     # [65536] int16 (<=0)
    lut_symbol: np.ndarray = field(default=None)   # [65536] uint8
    lut_phase: np.ndarray = field(default=None)    # [65536] int16 s_angle

    @property
    def name(self) -> str:
        return CSTLN_NAMES[self.predef]

    @property
    def bits_per_symbol(self) -> int:
        return int(self.nsymbols).bit_length() - 1

    def harden(self) -> None:
        """Convert soft metric to +-1 Hamming metric (sdr.h:564-571)."""
        c = self.lut_cost
        self.lut_cost = np.sign(c).astype(np.int16)


def _symbols_for(predef: Predef, gamma1=1.0, gamma2=1.0, gamma3=1.0) -> tuple:
    """Symbol tables per EN 300 421 / EN 302 307 (sdr.h:313-527)."""
    P = _polar
    if predef == Predef.BPSK:
        # BPSK at 45 degrees (sdr.h:322-325)
        return 2, [P(1, 8, 1), P(1, 8, 5)]
    if predef == Predef.QPSK:
        # EN 300 421 section 4.5 (sdr.h:328-338)
        return 4, [P(1, 4, 0.5), P(1, 4, 3.5), P(1, 4, 1.5), P(1, 4, 2.5)]
    if predef == Predef.PSK8:
        # EN 302 307 section 5.4.2 (sdr.h:340-353)
        order = [1, 0, 4, 5, 2, 7, 3, 6]
        return 8, [P(1, 8, k) for k in order]
    if predef == Predef.APSK16:
        # EN 302 307 section 5.4.3 (sdr.h:355-380)
        r1 = np.sqrt(4 / (1 + 3 * gamma1 * gamma1))
        r2 = gamma1 * r1
        inner = [1.5, 10.5, 4.5, 7.5, 0.5, 11.5, 5.5, 6.5, 2.5, 9.5, 3.5, 8.5]
        syms = [P(r2, 12, a) for a in inner]
        syms += [P(r1, 4, a) for a in (0.5, 3.5, 1.5, 2.5)]
        return 4, syms
    if predef == Predef.APSK32:
        # EN 302 307 section 5.4.3 (sdr.h:381-423)
        r1 = np.sqrt(8 / (1 + 3 * gamma1 * gamma1 + 4 * gamma2 * gamma2))
        r2, r3 = gamma1 * r1, gamma2 * r1
        spec = [
            (r2, 12, 1.5), (r2, 12, 2.5), (r2, 12, 10.5), (r2, 12, 9.5),
            (r2, 12, 4.5), (r2, 12, 3.5), (r2, 12, 7.5), (r2, 12, 8.5),
            (r3, 16, 1), (r3, 16, 3), (r3, 16, 14), (r3, 16, 12),
            (r3, 16, 6), (r3, 16, 4), (r3, 16, 9), (r3, 16, 11),
            (r2, 12, 0.5), (r1, 4, 0.5), (r2, 12, 11.5), (r1, 4, 3.5),
            (r2, 12, 5.5), (r1, 4, 1.5), (r2, 12, 6.5), (r1, 4, 2.5),
            (r3, 16, 0), (r3, 16, 2), (r3, 16, 15), (r3, 16, 13),
            (r3, 16, 7), (r3, 16, 5), (r3, 16, 8), (r3, 16, 10),
        ]
        return 4, [P(r, n, a) for (r, n, a) in spec]
    if predef == Predef.APSK64E:
        # EN 302 307-2 section 5.4.5 Table 13e (sdr.h:424-452)
        r1 = np.sqrt(64 / (4 + 12 * gamma1**2 + 20 * gamma2**2 + 28 * gamma3**2))
        r2, r3, r4 = gamma1 * r1, gamma2 * r1, gamma3 * r1
        quads = [
            (r4, (1 / 4, 7 / 4, 3 / 4, 5 / 4)),
            (r4, (13 / 28, 43 / 28, 15 / 28, 41 / 28)),
            (r4, (1 / 28, 55 / 28, 27 / 28, 29 / 28)),
            (r1, (1 / 4, 7 / 4, 3 / 4, 5 / 4)),
            (r4, (9 / 28, 47 / 28, 19 / 28, 37 / 28)),
            (r4, (11 / 28, 45 / 28, 17 / 28, 39 / 28)),
            (r3, (1 / 20, 39 / 20, 19 / 20, 21 / 20)),
            (r2, (1 / 12, 23 / 12, 11 / 12, 13 / 12)),
            (r4, (5 / 28, 51 / 28, 23 / 28, 33 / 28)),
            (r3, (9 / 20, 31 / 20, 11 / 20, 29 / 20)),
            (r4, (3 / 28, 53 / 28, 25 / 28, 31 / 28)),
            (r2, (5 / 12, 19 / 12, 7 / 12, 17 / 12)),
            (r3, (1 / 4, 7 / 4, 3 / 4, 5 / 4)),
            (r3, (7 / 20, 33 / 20, 13 / 20, 27 / 20)),
            (r3, (3 / 20, 37 / 20, 17 / 20, 23 / 20)),
            (r2, (1 / 4, 7 / 4, 3 / 4, 5 / 4)),
        ]
        syms = []
        for r, angles in quads:
            for a in angles:   # polar2 (sdr.h:497-504): phi = a*pi
                phi = a * np.pi
                re = np.float32(r * np.float32(np.cos(phi)) * CSTLN_AMP)
                im = np.float32(r * np.float32(np.sin(phi)) * CSTLN_AMP)
                syms.append((int(np.trunc(re)), int(np.trunc(im))))
        return 4, syms
    if predef in (Predef.QAM16, Predef.QAM64, Predef.QAM256):
        # make_qam (sdr.h:505-527), arbitrary mapping, experimental
        n = {Predef.QAM16: 16, Predef.QAM64: 64, Predef.QAM256: 256}[predef]
        m = int(np.sqrt(n))
        q = m // 2
        avgpower = 2 * (q * 0.25 + (q - 1) * q // 2
                        + (q - 1) * q * (2 * q - 1) // 6) / q
        scale = 1.0 / np.sqrt(avgpower)
        syms = []
        for x in range(m):
            for y in range(m):
                I = x - (m - 1) / 2
                Q = y - (m - 1) / 2
                re = np.float32(np.float32(I * scale) * CSTLN_AMP)
                im = np.float32(np.float32(Q * scale) * CSTLN_AMP)
                syms.append((int(np.trunc(re)), int(np.trunc(im))))
        return 4, syms
    raise ValueError(f"Constellation not implemented: {predef}")


def _build_lut(symbols: np.ndarray):
    """Vectorized make_lut_from_symbols (sdr.h:529-559).

    For every (I,Q) in [-128,128)^2: cost = d2_nearest - d2_second (<=0,
    each saturated at 32767 first), nearest symbol index (first wins ties),
    phase error = angle(I,Q) - angle(nearest symbol) as wrapped s16 angle.
    Grids are stored at index [(I & 255) * 256 + (Q & 255)].
    """
    Ivals = np.arange(-128, 128, dtype=np.int32)
    Qvals = np.arange(-128, 128, dtype=np.int32)
    I = Ivals[:, None, None]                     # [256,1,1]
    Q = Qvals[None, :, None]                     # [1,256,1]
    sre = symbols[:, 0].astype(np.int32)[None, None, :]
    sim = symbols[:, 1].astype(np.int32)[None, None, :]
    d2 = (I - sre) ** 2 + (Q - sim) ** 2         # [256,256,nsym]

    nearest = np.argmin(d2, axis=-1).astype(np.uint8)
    part = np.sort(d2, axis=-1)
    cost = np.minimum(part[..., 0], 32767)
    if d2.shape[-1] > 1:
        cost2 = np.minimum(part[..., 1], 32767)
    else:
        cost2 = np.full_like(cost, 32767 * 2)    # R*R*2 initial, unclamped path
        cost2 = np.minimum(cost2, 32767)
    softcost = (cost - cost2).astype(np.int16)

    ph_symbol = np.arctan2(
        symbols[:, 1].astype(np.float32), symbols[:, 0].astype(np.float32)
    ).astype(np.float32)
    ph_iq = np.arctan2(Q.astype(np.float32), I.astype(np.float32)
                       ).astype(np.float32)[:, :, 0]
    ph_err = ph_iq - ph_symbol[nearest]
    phase = np.trunc(ph_err.astype(np.float64) * 65536 / (2 * np.pi))
    phase = phase.astype(np.int64).astype(np.int16)  # wrap mod 65536

    # Reindex from [-128..127] grid to u8 = value & 255 layout.
    perm = (Ivals & 255).astype(np.int64)
    out_cost = np.empty((256, 256), np.int16)
    out_sym = np.empty((256, 256), np.uint8)
    out_phase = np.empty((256, 256), np.int16)
    out_cost[perm[:, None], perm[None, :]] = softcost
    out_sym[perm[:, None], perm[None, :]] = nearest
    out_phase[perm[:, None], perm[None, :]] = phase
    return out_cost.reshape(-1), out_sym.reshape(-1), out_phase.reshape(-1)


def make_constellation(predef: Predef, gamma1=1.0, gamma2=1.0,
                       gamma3=1.0) -> Cstln:
    nrot, syms = _symbols_for(predef, gamma1, gamma2, gamma3)
    symbols = np.array(syms, dtype=np.int8)
    cost, sym, phase = _build_lut(symbols.astype(np.int32))
    return Cstln(predef=predef, nsymbols=len(syms), nrotations=nrot,
                 symbols=symbols, lut_cost=cost, lut_symbol=sym,
                 lut_phase=phase)


# APSK radius ratios per code rate (dvb.h:45-81; EN 302 307 tables 9/10/13f).
_APSK16_GAMMA = {"2/3": 3.15, "4/6": 3.15, "3/4": 2.85, "4/5": 2.75,
                 "5/6": 2.70, "8/9": 2.60, "9/10": 2.57}
_APSK32_GAMMA = {"3/4": (2.84, 5.27), "4/5": (2.72, 4.87), "5/6": (2.64, 4.64),
                 "8/9": (2.54, 4.33), "9/10": (2.53, 4.30)}


@lru_cache(maxsize=None)
def make_dvbs2_constellation(predef: Predef, rate_name: str) -> Cstln:
    """make_dvbs2_constellation (dvb.h:45-81): pick gammas by code rate."""
    gamma1 = gamma2 = gamma3 = 1.0
    if predef == Predef.APSK16:
        if rate_name not in _APSK16_GAMMA:
            raise ValueError("Code rate not supported with APSK16")
        gamma1 = _APSK16_GAMMA[rate_name]
    elif predef == Predef.APSK32:
        if rate_name not in _APSK32_GAMMA:
            raise ValueError("Code rate not supported with APSK32")
        gamma1, gamma2 = _APSK32_GAMMA[rate_name]
    elif predef == Predef.APSK64E:
        gamma1, gamma2, gamma3 = 2.4, 4.3, 7.0  # Table 13f
    return make_constellation(predef, gamma1, gamma2, gamma3)
