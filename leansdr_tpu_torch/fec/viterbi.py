"""Viterbi trellis and sync-map tables (the host NumPy parts of
leansdr_tpu/fec/viterbi.py, copied; the decoder runs on the device in
fec/viterbi_device.py).

Mirrors trellis/viterbi_dec (reference viterbi.h:43-293) and viterbi_sync
(reference dvb.h:1173-1416): per code rate, a 64-state trellis whose coded
symbols span one full puncturing period (NCS = 2^bits_out), register-
exchange paths packed into 64-bit words, partial branch metrics from the
nearest-minus-second-nearest softsymbol costs, and nconj x nrot x nshift
decoder replicas elected by path-metric discriminant.

Tie-breaking follows the reference exactly: branches are scanned
provided-metric first then all coded symbols ascending, with '<=' so the
LAST minimal branch wins (viterbi.h:202-237).
"""

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from .convenc import POLYS, FEC_SPECS
from ..dsp.math_utils import parity_u64_np

NSTATES = 64

# bitpath depth per rate (dvb.h:1180-1212): (path bits per block, depth)
PATH_SPEC = {
    "1/2": (1, 32), "2/3": (3, 21), "4/6": (4, 16), "3/4": (3, 21),
    "4/5": (4, 16), "5/6": (5, 12), "7/8": (7, 9),
}


@dataclass
class Trellis:
    rate: str
    bits_in: int
    bits_out: int
    nus: int                  # 2^bits_in uncoded symbols
    ncs: int                  # 2^bits_out coded symbols
    pred: np.ndarray          # [64, NCS] predecessor state or -1
    us: np.ndarray            # [64, NCS] uncoded symbol
    # Dense incoming-branch view (each state has exactly NUS branches):
    in_cs: np.ndarray         # [64, NUS] coded symbol of branch k
    in_pred: np.ndarray       # [64, NUS]
    in_us: np.ndarray         # [64, NUS]


@lru_cache(maxsize=None)
def make_trellis(rate: str) -> Trellis:
    """init_convolutional (viterbi.h:61-92)."""
    bits_in, bits_out = FEC_SPECS[rate]
    polys = POLYS[rate]
    nus, ncs = 1 << bits_in, 1 << bits_out
    pred = np.full((NSTATES, ncs), -1, np.int32)
    usx = np.zeros((NSTATES, ncs), np.int32)
    for s in range(NSTATES):
        for us in range(nus):
            shiftreg = s
            us_rev = 0
            b = 1
            while b < nus:
                if us & b:
                    us_rev |= nus // 2 // b
                b *= 2
            shiftreg |= us_rev * NSTATES
            cs = 0
            for g in polys:
                cs = (cs << 1) | int(parity_u64_np(shiftreg & g))
            shiftreg //= nus
            if pred[shiftreg, cs] != -1:
                raise ValueError("Invalid convolutional code")
            pred[shiftreg, cs] = s
            usx[shiftreg, cs] = us
    # Dense incoming view in ascending-cs order (the reference's rescan
    # order, viterbi.h:224-233).
    in_cs = np.zeros((NSTATES, nus), np.int32)
    in_pred = np.zeros((NSTATES, nus), np.int32)
    in_us = np.zeros((NSTATES, nus), np.int32)
    for s in range(NSTATES):
        k = 0
        for cs in range(ncs):
            if pred[s, cs] >= 0:
                in_cs[s, k] = cs
                in_pred[s, k] = pred[s, cs]
                in_us[s, k] = usx[s, cs]
                k += 1
        assert k == nus
    return Trellis(rate, bits_in, bits_out, nus, ncs, pred, usx,
                   in_cs, in_pred, in_us)


def make_sync_maps(cstln, rate: str):
    """init_map for all (conj, rot) combinations (dvb.h:1336-1351).

    Returns (maps [nmaps, nsymbols], nconj, nrotations, nshifts, order)
    where sync s uses map[(s // nrotations) %% nconj * nrotations + rot].
    """
    bits_per_symbol = cstln.bits_per_symbol
    bits_in, bits_out = FEC_SPECS[rate]
    nconj = 1 if cstln.nsymbols == 2 else 2
    if cstln.nsymbols in (2, 4):
        nrotations = cstln.nrotations // 2
    else:
        nrotations = cstln.nrotations
    nshifts = bits_out // bits_per_symbol
    if nshifts * bits_per_symbol != bits_out:
        raise ValueError("Code rate not suitable for this constellation")
    lut_symbol = cstln.lut_symbol.reshape(256, 256)
    maps = np.zeros((nconj * nrotations, cstln.nsymbols), np.int32)
    for conj in range(nconj):
        for rot in range(nrotations):
            angle = 2 * np.pi * rot / cstln.nrotations
            ca, sa = np.float32(np.cos(angle)), np.float32(np.sin(angle))
            for i in range(cstln.nsymbols):
                I = np.float32(cstln.symbols[i, 0])
                Q = np.float32(cstln.symbols[i, 1])
                if conj:
                    Q = -Q
                RI = int(np.trunc(I * ca - Q * sa)) & 0xFF
                RQ = int(np.trunc(I * sa + Q * ca)) & 0xFF
                maps[conj * nrotations + rot, i] = lut_symbol[RI, RQ]
    return maps, nconj, nrotations, nshifts
