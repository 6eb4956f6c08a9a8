"""Viterbi trellis and sync-map tables (the host NumPy parts of
leansdr_tpu/fec/viterbi.py, copied) and the single-carrier decoder
ViterbiSyncDevice, whose ACS runs on the fleet's device kernels
(fec/viterbi_device.py, fec/viterbi_banked.py).

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


class ViterbiSyncDevice:
    """viterbi_sync (dvb.h:1173-1416): all-rate soft-decision Viterbi with
    periodic sync election, consuming (symbol, cost) softsymbol streams,
    with the ACS on the device and all replicas always on
    (leansdr_tpu/fec/viterbi.py:375-421): each 128-block chunk is ONE
    launch of the fleet's ACS kernels over the nsyncs replica lanes,
    where the JAX package runs a plain XLA scan (`_viterbi_chunk_device`):

      rate 1/2: `viterbi_acs` (csrc/acs.cu) at any nsyncs (BPSK: 2
        lanes, QPSK: 4), planes (metric, path) [64, S] in natural state
        order, path the low 32 bits of JAX's (path_hi, path_lo), which
        are all that reach the decision at traceback depth 32;
      2/3, 4/6, 3/4, 4/5, 5/6, 7/8: `viterbi_acs_banked`
        (csrc/acs_banked.cu), planes (metric, path_hi, path_lo) [64, S]
        in stored-row order.

    Every constellation and rate `make_sync_maps` takes: 1 to 16 sync
    maps (nconj 1 for BPSK) times nshifts symbol offsets.

    Both compute `_viterbi_chunk_device`'s function: per-step metric
    normalisation, the reference's tie rules, us at traceback depth and
    the best2-best discriminant. The trellis state is created on the
    first chunk (`_dev_state`), as in the JAX class.
    """

    CHUNK = 128

    def __init__(self, cstln, rate: str, fastlock: bool = False,
                 device=None):
        from .. import device as _dev
        self.device = _dev.resolve_device(device)
        self.rate = rate
        self.trellis = make_trellis(rate)
        self.bits_in = self.trellis.bits_in
        self.bps = cstln.bits_per_symbol
        maps, nconj, nrot, nshifts = make_sync_maps(cstln, rate)
        self.maps = maps
        self.nrot, self.nconj, self.nshifts = nrot, nconj, nshifts
        self.nsyncs = nconj * nrot * nshifts
        # sync s: rot = s%nrot, conj = (s//nrot)%nconj, shift = s//nrot//nconj
        self.sync_shift = np.array(
            [s // nrot // nconj for s in range(self.nsyncs)])
        self.sync_map = np.array(
            [(s // nrot) % nconj * nrot + (s % nrot)
             for s in range(self.nsyncs)])
        self.current = 0
        self.resync_phase = 0
        self.resync_period = 1 if fastlock else 32
        self.sym_backlog = np.empty(0, np.uint8)
        self.cost_backlog = np.empty(0, np.int16)

    @property
    def plane_keys(self) -> tuple:
        return (("metric", "path") if self.bits_in == 1
                else ("metric", "path_hi", "path_lo"))

    def _block_inputs(self, syms, costs, nblocks):
        """Per sync: coded symbols + costs for `nblocks` FEC blocks.

        Block b of sync s reads symbols [shift_s + b*nshifts, +nshifts),
        maps them, concatenates bits (dvb.h:1353-1363).
        """
        cs = np.zeros((self.nsyncs, nblocks), np.int64)
        cost = np.zeros((self.nsyncs, nblocks), np.int64)
        base = np.arange(nblocks)[None, :] * self.nshifts \
            + self.sync_shift[:, None]                       # [S, B]
        for i in range(self.nshifts):
            sym = syms[base + i]                             # [S, B]
            mapped = self.maps[self.sync_map[:, None], sym]
            cs = (cs << self.bps) | mapped
            cost = cost + costs[base + i]
        return cs, cost

    def process(self, syms: np.ndarray, costs: np.ndarray) -> np.ndarray:
        """Feed softsymbols; returns decoded bytes."""
        self.sym_backlog = np.concatenate([self.sym_backlog, syms])
        self.cost_backlog = np.concatenate([self.cost_backlog, costs])
        out = []
        need = self.nshifts * self.CHUNK + (self.nshifts - 1)
        while len(self.sym_backlog) >= need:
            out.append(self._chunk())
        return (np.concatenate(out) if out
                else np.empty(0, np.uint8))

    def _advance(self, us_current: np.ndarray, totaldiscr: np.ndarray,
                 election: bool) -> np.ndarray:
        """Drop the chunk's symbols, run the election (strictly greater
        switches, dvb.h:1404-1406) and pack the current sync's bits."""
        B = self.CHUNK
        out_bits = np.zeros((B, self.bits_in), np.uint8)
        for j in range(self.bits_in):
            out_bits[:, j] = (us_current >> (self.bits_in - 1 - j)) & 1
        self.sym_backlog = self.sym_backlog[B * self.nshifts:]
        self.cost_backlog = self.cost_backlog[B * self.nshifts:]
        if election:
            best = int(np.argmax(totaldiscr))
            if totaldiscr[best] > totaldiscr[self.current]:
                self.current = best
        self.resync_phase += 1
        if self.resync_phase >= self.resync_period:
            self.resync_phase = 0
        return np.packbits(out_bits.reshape(-1))

    def _chunk(self) -> np.ndarray:
        import torch
        from .viterbi_banked import viterbi_acs_banked
        from .viterbi_device import viterbi_acs
        B = self.CHUNK
        discr_delay = 64 // self.bits_in
        costs = self.cost_backlog.astype(np.int64)
        cs, cost = self._block_inputs(self.sym_backlog, costs, B)
        if not hasattr(self, "_dev_state"):
            self._dev_state = tuple(
                torch.zeros((NSTATES, self.nsyncs), dtype=torch.int32,
                            device=self.device) for _ in self.plane_keys)
        cs_d, cost_d = (torch.from_numpy(np.ascontiguousarray(
            a.T, np.int32)).to(self.device) for a in (cs, cost))
        if self.bits_in == 1:
            *planes, us, q = viterbi_acs(self.rate, *self._dev_state, cs_d,
                                         cost_d)
        else:
            *planes, us, q = viterbi_acs_banked(self.rate, *self._dev_state,
                                                cs_d, cost_d)
        self._dev_state = tuple(planes)
        usq = torch.stack([us, q]).cpu().numpy()          # [2, B, S]
        us, q = usq[0].T, usq[1].T
        totaldiscr = q[:, discr_delay:].sum(axis=1)
        return self._advance(us[self.current], totaldiscr,
                             self.resync_phase == 0)
