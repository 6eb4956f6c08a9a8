"""Algebraic deconvolution of DVB-S punctured convolutional codes: the
host NumPy decoder of the single-carrier receiver's hard-decision path
and the fleet batcher `BatchedDeconvolSync` (a NumPy copy of
leansdr_tpu/fec/deconv.py).

Mirrors deconvol_sync (reference dvb.h:122-476): at startup the
deconvolution polynomials are derived by solving the inverse convolution
(convolve / solve_rec / inverse_convolution, dvb.h:165-293), with the
reference's hardcoded alternate polynomials for error estimation, and
verified against the forward code for every input bit.

At run time the decoder is fully feed-forward: each output bit is the
parity of a fixed tap pattern over the recent IQ bit history, so the
vectorized form is an XOR-reduction of statically-shifted bit lanes over
the whole symbol block, under any of the 4 sync hypotheses (2 rotations
x 2 conjugations, dvb.h:308-360).
"""

from functools import lru_cache

import numpy as np

from ..dsp.math_utils import log2i
from .convenc import DVBS_G1, DVBS_G2

TRACEBACK = 64  # dvb.h:203

# Puncturing masks per rate (make_deconvol_sync_simple, dvb.h:487-507).
PUNCTURE = {
    "1/2": (0x1, 0x1),
    "2/3": (0xA, 0xF),   # handled as 4/6, no half-symbols
    "4/6": (0xA, 0xF),
    "3/4": (0x5, 0x6),
    "5/6": (0x15, 0x1A),
    "7/8": (0x45, 0x7A),
}

# Alternate polynomials for fastlock error estimation (dvb.h:236-263).
_ALT = {
    0x3BA: 0x38CCA,
    0xF29: 0x3C569329, 0x3C552: 0x1DEE1C, 0x7948: 0x1E2B49948,
    0x1DE: 0x1E2A90,
    0xF247: 0xFD6383B, 0xFD9EE: 0xFD91392, 0xF248D8: 0xFD9EEF18,
    0xF5727F: 0x3D5C909758F, 0x3D5C90AA: 0xF5727F0229C90AA,
    0x3DAA371C: 0x3D5F45630EC, 0xF5727FF48: 0xF57D28260348,
    0xF57D28260: 0xF5727FF48128260,
    0xFBEAC76C454F: 0xFB11D6BA045A8F, 0xFB11D6BA: 0xFBEA3C7D930E16BA,
    0xFB112D5038DC: 0xFB112D5038271C, 0xFBEA3C7D68: 0xFBEAC7975462A8,
    0xFB112D50: 0xFBEA3C86793290, 0xFB112DABD2E0: 0xFB112D50C3CD20,
    0xFB11D640: 0xFBEA3C8679C980,
}


def _parity(x: int) -> int:
    return bin(x).count("1") & 1


class DeconvSpec:
    """Derived deconvolution polynomials for one code rate."""

    def __init__(self, rate: str, gX: int = DVBS_G1, gY: int = DVBS_G2):
        self.rate = rate
        pX, pY = PUNCTURE[rate]
        self.conv = (gX, gY)
        self.punct = (pX, pY)
        self.punctperiod = max(log2i(pX) + 1, log2i(pY) + 1)
        self.punctweight = bin(pX).count("1") + bin(pY).count("1")
        self._inverse_convolution()

    def convolve(self, s: int) -> int:
        """Forward punctured convolution of a bit signal (dvb.h:165-179)."""
        sbits = log2i(s) + 1
        iq = 0
        state = 0
        for b in range(sbits - 1, -1, -1):
            bit = (s >> b) & 1
            state = (state >> 1) | (bit << 6)
            for j, g in enumerate(self.conv):
                xy = _parity(state & g)
                if self.punct[j] & (1 << (b % self.punctperiod)):
                    iq = (iq << 1) | xy
        return iq

    def _solve_rec(self, prefix, nprefix, exp, best):
        """Branch-and-bound search for the minimal deconvolution polynomial
        (dvb.h:205-221)."""
        if prefix > best[0]:
            return
        if nprefix > 64:
            return
        solved = True
        for b in range(64):
            if _parity(prefix & self.response[b]) != ((exp >> b) & 1):
                if (self.response[b] >> nprefix) == 0:
                    return
                solved = False
        if solved:
            best[0] = prefix
            return
        self._solve_rec(prefix, nprefix + 1, exp, best)
        self._solve_rec(prefix | (1 << nprefix), nprefix + 1, exp, best)

    def _inverse_convolution(self):
        """Derive deconv polynomials and verify them (dvb.h:225-293)."""
        self.response = [self.convolve(1 << sbit) for sbit in range(64)]
        self.deconv = []
        self.deconv2 = []
        for b in range(self.punctperiod):
            best = [(1 << 64) - 1]
            self._solve_rec(0, 0, 1 << b, best)
            d = best[0]
            self.deconv.append(d)
            d2 = _ALT.get(d, d)
            if d2 == d:
                raise ValueError("Alt polynomial not provided")
            self.deconv2.append(d2)

        # Sanity check (dvb.h:274-292): deconv must invert the code for
        # every input bit, and fit the traceback window.
        for b in range(self.punctperiod):
            for i in range(64):
                iq = self.convolve(1 << i)
                expect = 1 if b == i else 0
                if _parity(iq & self.deconv[b]) != expect:
                    raise AssertionError("Failed to inverse convolutional coding")
                if _parity(iq & self.deconv2[b]) != expect:
                    raise AssertionError(
                        "Failed to inverse convolutional coding (alt)")
            if log2i(self.deconv[b]) + 1 > TRACEBACK:
                raise AssertionError("traceback insufficient")
            if log2i(self.deconv2[b]) + 1 > TRACEBACK:
                raise AssertionError("traceback insufficient (alt)")


@lru_cache(maxsize=None)
def deconv_spec(rate: str) -> DeconvSpec:
    return DeconvSpec(rate)


@lru_cache(maxsize=None)
def sync_maps() -> np.ndarray:
    """[4,4] uint8: per sync hypothesis, symbol index -> 2 IQ bits.

    Derived from init_syncs (dvb.h:308-360): map[sync][s] = lut[re][im]
    indexed by re=(s>>1)&1, im=s&1.  180-degree rotations are covered by
    polarity inversion in mpeg_sync.
    """
    maps = np.zeros((4, 4), dtype=np.uint8)
    for sync_id in range(4):
        for re_pos in (0, 1):
            for im_pos in (0, 1):
                re_neg, im_neg = 1 - re_pos, 1 - im_pos
                if sync_id == 0:     # Direct 0
                    I, Q = (0 if re_pos else 1), (0 if im_pos else 1)
                elif sync_id == 1:   # Direct 90
                    I, Q = (0 if im_pos else 1), (0 if re_neg else 1)
                elif sync_id == 2:   # Conj 0
                    I, Q = (0 if re_pos else 1), (1 if im_pos else 0)
                else:                # Conj 90
                    I, Q = (1 if im_pos else 0), (0 if re_neg else 1)
                s = (re_pos << 1) | im_pos
                maps[sync_id, s] = (I << 1) | Q
    return maps


def _tap_positions(poly: int) -> np.ndarray:
    """Window-bit positions (0 = newest) of a deconv polynomial's taps."""
    return np.array([j for j in range(64) if (poly >> j) & 1], dtype=np.int64)


@lru_cache(maxsize=None)
def _deconv_plan(rate: str, alt: bool):
    """Static gather plan: for each (period-phase b), the tap offsets into
    the IQ bitstream, expressed relative to the period end index."""
    spec = deconv_spec(rate)
    polys = spec.deconv2 if alt else spec.deconv
    return [(_tap_positions(p)) for p in polys], spec


def hs_sync_maps() -> np.ndarray:
    """The --hs deconvolver's 4 sync LUTs (dvb_deconvol_sync init_syncs,
    dvb.h:673-701): symbol index -> 2 IQ bits per rotation/conjugation."""
    return np.array([[0, 1, 2, 3],      # 0 deg
                     [2, 0, 3, 1],      # 90 deg
                     [1, 0, 3, 2],      # 0 deg conjugated
                     [0, 2, 1, 3]],     # 90 deg conjugated
                    dtype=np.uint8)


def deconvolve_block(symbols: np.ndarray, rate: str, sync_id: int,
                     alt: bool = False, symmap=None) -> np.ndarray:
    """Decode a block of hard symbols into bytes (vectorized readbyte,
    dvb.h:369-389).

    The caller must pass symbols starting exactly at the deconvolver's
    current alignment; the first output period consumes TRACEBACK bits.
    Output periods p=0..P-1 have window end e_p = TRACEBACK + p*punctweight
    in the bitstream; output bit (p, b) = parity(window_p & deconv[b]) with
    window bit j == bitstream[e_p - 1 - j]; bits emitted b descending then
    packed 8-per-byte MSB-first.

    Returns the byte array; the number of full bytes is
    floor(P * punctperiod / 8) with P chosen so it divides evenly.
    `symmap` (4 entries), when given, replaces sync map `sync_id`.
    """
    taps_list, spec = _deconv_plan(rate, alt)
    m = sync_maps()[sync_id] if symmap is None else symmap
    iqbits2 = m[symbols]                       # 2-bit values per symbol
    bits = np.empty(2 * len(symbols), dtype=np.uint8)
    bits[0::2] = (iqbits2 >> 1) & 1            # I first (iq = (iq<<2)|iqbits)
    bits[1::2] = iqbits2 & 1
    nb = len(bits)
    P = (nb - TRACEBACK) // spec.punctweight + 1 if nb >= TRACEBACK else 0
    # Only emit whole bytes.
    per_byte = 8 // np.gcd(8, spec.punctperiod) * spec.punctperiod // 8  # noqa
    nperiods_per_byteblock = np.lcm(8, spec.punctperiod) // spec.punctperiod
    P = (P // nperiods_per_byteblock) * nperiods_per_byteblock
    if P <= 0:
        return np.empty(0, np.uint8)
    e_p = TRACEBACK + np.arange(P) * spec.punctweight
    out_bits = np.empty((P, spec.punctperiod), dtype=np.uint8)
    for b in range(spec.punctperiod):
        taps = taps_list[b]
        acc = np.zeros(P, dtype=np.uint8)
        for j in taps:
            acc ^= bits[e_p - 1 - j]
        # Emission order is b = punctperiod-1 .. 0 (dvb.h:379-382).
        out_bits[:, spec.punctperiod - 1 - b] = acc
    stream = out_bits.reshape(-1)
    return np.packbits(stream)


def deconvolve_errors(symbols: np.ndarray, rate: str, sync_id: int,
                      symmap=None) -> int:
    """Count bits where primary and alternate polynomials disagree
    (readerrors, dvb.h:391-412) — the fastlock election metric.

    For rate 1/2 this equals parity(window & POLY_ERRORS) with
    POLY_ERRORS = deconv ^ deconv2 (= 0x38f70, the --hs error polynomial,
    dvb.h:667)."""
    taps_list, spec = _deconv_plan(rate, False)
    taps2_list, _ = _deconv_plan(rate, True)
    m = sync_maps()[sync_id] if symmap is None else symmap
    iqbits2 = m[symbols]
    bits = np.empty(2 * len(symbols), dtype=np.uint8)
    bits[0::2] = (iqbits2 >> 1) & 1
    bits[1::2] = iqbits2 & 1
    nb = len(bits)
    if nb < TRACEBACK:
        return 0
    P = (nb - TRACEBACK) // spec.punctweight + 1
    nppb = np.lcm(8, spec.punctperiod) // spec.punctperiod
    P = (P // nppb) * nppb
    if P <= 0:
        return 0
    e_p = TRACEBACK + np.arange(P) * spec.punctweight
    errs = 0
    for b in range(spec.punctperiod):
        a1 = np.zeros(P, dtype=np.uint8)
        a2 = np.zeros(P, dtype=np.uint8)
        for j in taps_list[b]:
            a1 ^= bits[e_p - 1 - j]
        for j in taps2_list[b]:
            a2 ^= bits[e_p - 1 - j]
        errs += int(np.sum(a1 != a2))
    return errs


def bytes_to_symbol_count(nbytes: int, rate: str) -> int:
    """Symbols consumed per `nbytes` output bytes once the window is full."""
    spec = deconv_spec(rate)
    return nbytes * 8 // spec.punctperiod * spec.punctweight // 2


class BatchedDeconvolSync:
    """Deconvolution for many channels in lockstep (SURVEY.md 2.10 P2/P6:
    bit-parallelism and hypothesis-parallelism as batch axes).

    All channels share one code rate; each round decodes a fixed block of
    symbols per channel with ALL 4 sync hypotheses as a leading batch
    axis — tap XORs are ~7 vectorized ops for the whole fleet instead of
    per-channel loops. Election per block mirrors the fastlock rules
    (fewest estimated errors; symbol slip when BER > 1/3).
    """

    def __init__(self, rate: str, nchan: int, fastlock: bool = True,
                 symmaps=None):
        self.spec = deconv_spec(rate)
        pp = self.spec.punctperiod
        # Periods per round: byte-aligned (pp bits/period) and ~4096
        # symbols of election cadence like the reference's BUF_SYMBOLS.
        align = int(np.lcm(8, pp)) // pp
        self.PERIODS = max(1, (4096 * 2 // self.spec.punctweight)
                           // align) * align
        self.rate = rate
        self.nchan = nchan
        self.fastlock = fastlock
        self.maps = sync_maps() if symmaps is None else symmaps
        self.locked = np.zeros(nchan, np.int64)
        self.backlogs = [np.empty(0, np.uint8) for _ in range(nchan)]
        self.taps = [_tap_positions(d) for d in self.spec.deconv]
        self.taps2 = [_tap_positions(d) for d in self.spec.deconv2]

    @property
    def consumed_symbols(self):
        return self.PERIODS * self.spec.punctweight // 2

    def process(self, syms_list):
        """syms_list: per-channel new symbols. Returns per-channel bytes."""
        for c, s in enumerate(syms_list):
            self.backlogs[c] = np.concatenate([self.backlogs[c], s])
        out = [[] for _ in range(self.nchan)]
        need = self.consumed_symbols + TRACEBACK // 2
        while min(len(b) for b in self.backlogs) >= need:
            block = np.stack([b[:need] for b in self.backlogs])  # [C, need]
            by, skip = self._decode_block(block)
            for c in range(self.nchan):
                out[c].append(by[c])
                drop = self.consumed_symbols + (1 if skip[c] else 0)
                self.backlogs[c] = self.backlogs[c][drop:]
        return [np.concatenate(o) if o else np.empty(0, np.uint8)
                for o in out]

    def _decode_block(self, symbols):
        C, n = symbols.shape
        pp = self.spec.punctperiod
        pw = self.spec.punctweight
        iq2 = self.maps[:, symbols]               # [4, C, n]
        bits = np.empty((4, C, 2 * n), np.uint8)
        bits[:, :, 0::2] = (iq2 >> 1) & 1
        bits[:, :, 1::2] = iq2 & 1
        P = self.PERIODS
        # Window-end bit index for period p is TRACEBACK + p*punctweight;
        # tap j of poly b reads bit (end-1-j) — an arithmetic sequence
        # with stride punctweight, i.e. a strided VIEW (no gather copies).
        # Emission order within a period: b = punctperiod-1 .. 0
        # (dvb.h:379-382).
        dec = np.zeros((4, C, P, pp), np.uint8)
        err = np.zeros((4, C, P, pp), np.uint8)
        for b in range(pp):
            for j in self.taps[b]:
                lo = TRACEBACK - 1 - int(j)
                dec[:, :, :, pp - 1 - b] ^= bits[:, :, lo: lo + pw * P: pw]
            for j in self.taps2[b]:
                lo = TRACEBACK - 1 - int(j)
                err[:, :, :, pp - 1 - b] ^= bits[:, :, lo: lo + pw * P: pw]
        err ^= dec                                 # disagreement bits
        errs = err.sum(axis=(2, 3))                # [4, C]
        if self.fastlock:
            best = np.argmin(errs, axis=0)
            self.locked = best
        ch = np.arange(C)
        sel = dec[self.locked, ch].reshape(C, P * pp)
        nbytes = P * pp // 8
        skip = (errs[self.locked, ch] > nbytes * 8 // 3) if self.fastlock \
            else np.zeros(C, bool)
        return np.packbits(sel, axis=1), skip
