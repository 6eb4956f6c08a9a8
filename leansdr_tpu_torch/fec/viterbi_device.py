"""Multi-channel soft-decision Viterbi on the device: the rate-1/2 ACS
kernel batched over channels x sync replicas, with sync election (the
counterpart of leansdr_tpu/fec/viterbi_device.py).

viterbi_sync (reference dvb.h:1173-1416) for the K=7, bits_in=1 trellis:

* The ACS butterfly is constant-geometry: new states j and j+32 share
  the predecessor pair (2j, 2j+1) and differ only in the shifted-in bit
  (j >> 5), so one step needs no gathers.
* Register-exchange paths (bitpath, viterbi.h:287-293) are one u32 word
  per state (rate-1/2 traceback depth is 32, dvb.h:1180).
* Tie-breaking matches viterbi_dec exactly (viterbi.h:202-244): branch
  candidates are scanned [provided-with-metric, then cs-ascending] with
  '<=' (the LAST minimum wins), and the best-state scan uses '<' (the
  FIRST minimum wins), realized with (metric*64 | state) packed keys.
* The reference's resync_period time-multiplexing of the 4 sync replicas
  becomes hypothesis parallelism: all replicas advance every block and a
  strictly-greater discriminant election runs per P_SUB-block sub-block.

`viterbi_acs` launches csrc/acs.cu for CUDA tensors and runs
`viterbi_acs_ref`, the plain PyTorch version, for CPU tensors. Lanes are
channel x sync replica, with no padding: the planes are [64, N].
"""

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .. import device as _dev
from .deconv_device import DELTA_MAX, deconv_append
from .viterbi import PATH_SPEC, make_sync_maps, make_trellis

NSYNCS = 4          # nconj x nrot for QPSK-class constellations
P_SUB = 1024        # blocks per election sub-block
BIG = 1 << 30


@lru_cache(maxsize=None)
def _butterfly_tables(rate: str):
    """Static per-new-state branch tables for the constant-geometry ACS.

    For new state s' = j + 32h the two incoming branches come from preds
    2j and 2j+1; returns [2, 32] int32 arrays:
      cs_even[h][j]  coded symbol of branch pred=2j   -> s'
      cs_odd[h][j]   coded symbol of branch pred=2j+1 -> s'
      swap[h][j]     1 if the odd branch has the SMALLER cs (so it comes
                     first in the reference's rescan order)
    """
    t = make_trellis(rate)
    if t.bits_in != 1:
        raise NotImplementedError(
            f"rate {rate}: the punctured-rate (banked) ACS is ROADMAP "
            "queue 1 item 9")
    cs_even = np.zeros((2, 32), np.int32)
    cs_odd = np.zeros((2, 32), np.int32)
    for h in range(2):
        for j in range(32):
            sp = j + 32 * h
            for k in range(2):          # branch from pred 2j+k
                cs = int(np.where(t.pred[sp] == 2 * j + k)[0][0])
                (cs_even if k == 0 else cs_odd)[h, j] = cs
    swap = (cs_odd < cs_even).astype(np.int32)
    return cs_even, cs_odd, swap


def viterbi_acs_ref(rate: str, metric: torch.Tensor, path: torch.Tensor,
                    cs: torch.Tensor, cost: torch.Tensor,
                    cheap_q: bool = False):
    """Plain PyTorch ACS over T blocks, the kernel's integer arithmetic.

    metric [64, N] i32, path [64, N] i32 (u32 bits), cs/cost [T, N] i32.
    Returns (metric, path, us [T, N] i32 decoded bit at traceback depth,
    q [T, N] i32 best2-best discriminant). With cheap_q, q is computed
    for blocks 4i only (zeros elsewhere): the TRACK watchdog's subsample.
    """
    nbits, depth = PATH_SPEC[rate]
    shift = (depth - 1) * nbits
    dev = cs.device
    T, N = cs.shape
    ce, co, sw = (torch.from_numpy(a).to(dev)[:, :, None]
                  for a in _butterfly_tables(rate))       # [2, 32, 1]
    swb = sw.bool()
    sidx = (torch.arange(32, dtype=torch.int32, device=dev)[None, :, None]
            + torch.tensor([0, 32], dtype=torch.int32,
                           device=dev)[:, None, None])    # [2, 32, 1]
    m = metric.clone()
    p = path.clone()
    us = torch.empty((T, N), dtype=torch.int32, device=dev)
    q = torch.zeros((T, N), dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    for t in range(T):
        cs_b = cs[t][None, :]
        c_b = cost[t][None, :]
        me, mo = m[0::2], m[1::2]                        # [32, N]
        pe, po = p[0::2], p[1::2]
        new_m, new_p, keys = [], [], []
        for h in range(2):
            match_o = co[h] == cs_b
            Me = me + torch.where(ce[h] == cs_b, c_b, zero)
            Mo = mo + torch.where(match_o, c_b, zero)
            nm = torch.minimum(Me, Mo)
            # Reference scan order [provided, cs-ascending branches],
            # '<=': the last minimum wins.
            m_first = torch.where(swb[h], mo, me)
            m_second = torch.where(swb[h], me, mo)
            sel_odd = torch.where(m_second == nm, ~swb[h],
                                  torch.where(m_first == nm, swb[h],
                                              match_o))
            npth = (torch.where(sel_odd, po, pe) << 1) | h
            keys.append(((nm * 64 + sidx[h]) << 1) | ((npth >> shift) & 1))
            new_m.append(nm)
            new_p.append(npth)
        best_key = torch.minimum(keys[0].amin(0), keys[1].amin(0))
        best_m = best_key >> 7
        us[t] = best_key & 1
        if not cheap_q or t % 4 == 0:
            second = torch.minimum(
                *(torch.where(k == best_key, BIG, k).amin(0) for k in keys))
            q[t] = (second >> 7) - best_m
        m = torch.cat([new_m[0] - best_m, new_m[1] - best_m])
        p = torch.cat(new_p)
    return m, p, us, q


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _dev.load("acs")
        lib.acs_launch.restype = ctypes.c_int
        lib.acs_launch.argtypes = (
            [ctypes.c_void_p] * 9
            + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_void_p])
        _lib = lib
    return _lib


_tables = {}


def _device_tables(rate: str, dev) -> torch.Tensor:
    """[3, 2, 32] int32 (cs_even, cs_odd, swap) on `dev`, cached."""
    key = (rate, str(dev))
    if key not in _tables:
        _tables[key] = torch.from_numpy(
            np.stack(_butterfly_tables(rate))).to(dev).contiguous()
    return _tables[key]


def viterbi_acs(rate: str, metric: torch.Tensor, path: torch.Tensor,
                cs: torch.Tensor, cost: torch.Tensor, cheap_q: bool = False):
    """Run the ACS over T blocks (same contract as viterbi_acs_ref).

    CPU tensors run `viterbi_acs_ref`; CUDA tensors launch csrc/acs.cu
    (T must be a multiple of 32).
    """
    if cs.device.type == "cpu":
        return viterbi_acs_ref(rate, metric, path, cs, cost, cheap_q)
    T, N = cs.shape
    if T % 32:
        raise ValueError(f"T={T} is not a multiple of 32")
    dev = cs.device
    for name, t, shape in (("metric", metric, (64, N)),
                           ("path", path, (64, N)), ("cs", cs, (T, N)),
                           ("cost", cost, (T, N))):
        _dev.check_tensor(name, t, torch.int32, shape, dev)
    nbits, depth = PATH_SPEC[rate]
    lib = _kernel()
    tbl = _device_tables(rate, dev)
    m2 = torch.empty_like(metric)
    p2 = torch.empty_like(path)
    us = torch.empty((T, N), dtype=torch.int32, device=dev)
    q = torch.empty((T, N), dtype=torch.int32, device=dev)
    err = lib.acs_launch(tbl.data_ptr(), metric.data_ptr(), path.data_ptr(),
                         cs.data_ptr(), cost.data_ptr(), m2.data_ptr(),
                         p2.data_ptr(), us.data_ptr(), q.data_ptr(),
                         T, N, (depth - 1) * nbits, int(cheap_q),
                         _dev.stream_handle(cs))
    _dev.check_launch("acs", err)
    _VITERBI_ACS.launches += 1
    return m2, p2, us, q


# Launch count of the kernel (a plain integer; increments only where
# the kernel launches). Bound through an alias so a caller that rebinds
# the module attribute (e.g. to time it) still counts.
viterbi_acs.launches = 0
_VITERBI_ACS = viterbi_acs


# ---------------------------------------------------------------------------
# Fleet wrapper
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ViterbiPlan:
    """Static geometry for one (rate, nchan, chunk) configuration."""
    rate: str
    nchan: int
    nsamp: int
    nshifts: int
    E: int                  # sub-blocks per decode
    cap: int                # symbol ring capacity
    store_costs: bool = True
    # nsyncs=1 is TRACK mode: only each channel's elected sync replica
    # runs (the analogue of the reference's resync_period gating).
    nsyncs: int = NSYNCS

    @property
    def nblocks(self) -> int:
        return self.E * P_SUB

    @property
    def consumed(self) -> int:
        return self.nblocks * self.nshifts

    @property
    def needed(self) -> int:
        return self.consumed + self.nshifts - 1

    @property
    def nbytes(self) -> int:
        return self.nblocks * make_trellis(self.rate).bits_in // 8

    @property
    def n_lanes(self) -> int:
        return self.nchan * self.nsyncs


_BYTE_WEIGHTS = (1 << np.arange(7, -1, -1)).astype(np.int32)


def viterbi_decode(plan: ViterbiPlan, state: dict, maps):
    """Decode plan.nblocks FEC blocks from the ring front.

    Returns (new_state, bytes [C, nbytes] u8, discr [C, E+1] i32 for the
    elected sync with the elected sync index in the last column,
    underflow [C] bool). Stays on the device: no value is read back.
    """
    C, E = plan.nchan, plan.E
    T = plan.nblocks
    dev = state["buf"].device
    underflow = state["fill"] < plan.needed
    # Per-sync block inputs (dvb.h:1353-1363): QPSK rate 1/2 has one
    # symbol per block and the same shift for all 4 syncs.
    sym = state["buf"][:T].to(torch.int64)                  # [T, C]
    cost_b = state["cost"][:T].to(torch.int32)
    maps_arr = torch.tensor(maps, dtype=torch.int32, device=dev)  # [4, ns]
    track = plan.nsyncs == 1
    if track:
        msel = maps_arr[state["tsync"].to(torch.int64)]      # [C, nsym]
        cs = msel.t().gather(0, sym)                          # [T, C]
        costf = cost_b
        ncols = C
    else:
        cs = maps_arr[:, sym].permute(1, 2, 0)                # [T, C, 4]
        costf = cost_b[:, :, None].expand(T, C, NSYNCS)
        ncols = C * NSYNCS
    csf = cs.reshape(T, ncols).contiguous()
    costf = costf.reshape(T, ncols).contiguous()

    m2, p2, us, q = viterbi_acs(plan.rate, state["metric"], state["path"],
                                csf, costf, cheap_q=track)
    us = us.reshape(T, C, plan.nsyncs)
    q = q.reshape(T, C, plan.nsyncs)

    # Election: per-sub-block discriminant sums, strictly-greater switch
    # applied AFTER each sub-block (dvb.h:1380-1412; discr_delay skip of
    # the first 64/bits_in blocks approximated at sub-block starts).
    dd = 64
    qsum = q.reshape(E, P_SUB, C, plan.nsyncs)[:, dd:].sum(
        dim=1, dtype=torch.int32)                             # [E, C, ns]
    if track:
        cur_out = state["current"]
        bits = us.reshape(T, C).t()
        # cheap_q subsampled 1-in-4 blocks; rescale to full-sum units so
        # the watchdog threshold (entered from ACQUIRE) still holds.
        dsel = 4 * qsum[:, :, 0].t()                          # [C, E]
    else:
        cur = state["current"].to(torch.int64)
        elected = []
        for e in range(E):
            qk = qsum[e]                                      # [C, 4]
            best = torch.argmax(qk, dim=1)                    # first max
            bv = qk.gather(1, best[:, None])[:, 0]
            cv = qk.gather(1, cur[:, None])[:, 0]
            elected.append(cur)                               # pre-update
            cur = torch.where(bv > cv, best, cur)
        cur_out = cur.to(torch.int32)
        elected = torch.stack(elected)                        # [E, C]
        use = us.reshape(E, P_SUB, C, NSYNCS)
        sel = use.gather(3, elected[:, None, :, None].expand(
            E, P_SUB, C, 1))[..., 0]
        bits = sel.reshape(T, C).t()                          # [C, T]
        dsel = qsum.gather(2, elected[:, :, None])[:, :, 0].t()
    w = torch.from_numpy(_BYTE_WEIGHTS).to(dev)
    by = (bits.reshape(C, T // 8, 8) * w).sum(
        dim=2, dtype=torch.int32).to(torch.uint8)
    dsel = torch.cat([dsel.to(torch.int32),
                      (state["tsync"] if track else cur_out)[:, None]], 1)

    Sc = plan.consumed
    buf = torch.cat([state["buf"][Sc:], torch.zeros(
        (Sc, C), dtype=torch.uint8, device=dev)])
    cbuf = torch.cat([state["cost"][Sc:], torch.zeros(
        (Sc, C), dtype=torch.int16, device=dev)])
    new = dict(state, buf=buf, cost=cbuf,
               fill=(state["fill"] - Sc).clamp(min=0),
               metric=m2, path=p2, current=cur_out)
    return new, by, dsel, underflow


def _planes_to_track(metric, path, current, C: int):
    """Keep only each channel's elected sync replica's trellis state."""
    cols = (torch.arange(C, device=metric.device) * NSYNCS
            + current.to(torch.int64))
    return metric[:, cols].contiguous(), path[:, cols].contiguous()


def _planes_to_acquire(metric, path, C: int):
    """Seed all 4 replicas from the tracked trellis state (they diverge
    within one traceback depth, like the reference's fresh replicas)."""
    return (metric[:, :C].repeat_interleave(NSYNCS, dim=1).contiguous(),
            path[:, :C].repeat_interleave(NSYNCS, dim=1).contiguous())


class MultiViterbiSync:
    """N-channel viterbi_sync: symbol+cost ring -> ACS kernel over all
    sync replicas -> elected bit stream, packed to bytes on the device.

    Rate 1/2 on a 4-sync constellation (QPSK) only. `fastlock` is
    accepted for interface parity: replicas are always on, so both modes
    use the same election.
    """

    kind = "viterbi"

    def __init__(self, cstln, rate: str, nchan: int, nsamp: int,
                 omega: float, fastlock: bool = True, device=None):
        maps, nconj, nrot, nshifts = make_sync_maps(cstln, rate)
        if not (nconj * nrot == NSYNCS and nshifts == 1):
            raise NotImplementedError(
                f"rate {rate} on {cstln.name}: the punctured-rate Viterbi "
                "is ROADMAP queue 1 item 9")
        _butterfly_tables(rate)              # raises for bits_in > 1
        self.device = _dev.resolve_device(device)
        self.maps = tuple(tuple(int(v) for v in row) for row in maps)
        prod = int(nsamp / omega)
        E = max(1, prod // (P_SUB * nshifts))
        cap = E * P_SUB * nshifts + prod + nsamp + DELTA_MAX + 8192
        self.plan = ViterbiPlan(rate, nchan, nsamp, nshifts, E, cap)
        self.plan_track = ViterbiPlan(rate, nchan, nsamp, nshifts, E, cap,
                                      nsyncs=1)
        C = nchan
        dev = self.device
        i32 = dict(dtype=torch.int32, device=dev)
        self.state = {
            "buf": torch.zeros((cap, C), dtype=torch.uint8, device=dev),
            "cost": torch.zeros((cap, C), dtype=torch.int16, device=dev),
            "fill": torch.zeros(C, **i32),
            "current": torch.zeros(C, **i32),
            "tsync": torch.zeros(C, **i32),
            "metric": torch.zeros((64, self.plan.n_lanes), **i32),
            "path": torch.zeros((64, self.plan.n_lanes), **i32),
        }
        self._est_fill = 0
        # TRACK-mode policy (host side, fed by observe() from the fetched
        # discriminants, one chunk of lag): enter after `track_after`
        # consecutive decodes with a fleet-wide stable election; leave
        # when any channel's tracked discriminant falls below HALF its
        # entry level, and every `probe_period` TRACK decodes re-acquire
        # for one election round (the reference's periodic resync,
        # dvb.h:1386-1394).
        self.track = False
        self.track_after = 2
        self.probe_period = 32
        self._track_decodes = 0
        self._want_track = False
        self._last_cur = None
        self._stable = 0
        self._entry_d = None

    def append(self, sym, valid, cost):
        self.state = deconv_append(self.plan, self.state, sym, valid, cost)

    def note_production(self, nsyms_min: int):
        self._est_fill += nsyms_min

    def sync_fill(self, fill: np.ndarray):
        self._est_fill = int(fill.min())

    def can_decode(self) -> bool:
        return self._est_fill >= self.plan.needed

    def apply_pending_transition(self):
        """Apply a pending ACQUIRE<->TRACK switch to the trellis planes
        (requested by observe() between chunks)."""
        if self._want_track == self.track:
            return
        C = self.plan.nchan
        st = self.state
        if self._want_track:
            m, p = _planes_to_track(st["metric"], st["path"],
                                    st["current"], C)
            self.state = dict(st, metric=m, path=p, tsync=st["current"])
        else:
            m, p = _planes_to_acquire(st["metric"], st["path"], C)
            self.state = dict(st, metric=m, path=p, current=st["tsync"])
        self.track = self._want_track

    def decode(self):
        self.apply_pending_transition()
        plan = self.plan_dec
        self.state, by, discr, under = viterbi_decode(plan, self.state,
                                                      self.maps)
        self._est_fill -= plan.consumed
        return by, discr, under

    @property
    def plan_dec(self):
        return self.plan_track if self.track else self.plan

    def schedule_decode(self) -> int:
        """Bookkeeping-only equivalent of `while can_decode(): decode`."""
        k = 0
        while self.can_decode():
            self._est_fill -= self.plan_dec.consumed
            k += 1
        return k

    def observe(self, discr: np.ndarray, under: np.ndarray):
        """Host feedback from a fetched decode: discr [C, E+1] i32 with
        the elected sync index in the last column. Drives the
        ACQUIRE<->TRACK transition (see __init__)."""
        if under.any():
            return
        cur = discr[:, -1]
        d = discr[:, :-1].mean(axis=1)
        if self.track or self._want_track:
            self._track_decodes += 1
            collapse = (d < 0.5 * self._entry_d).any()
            probe = self._track_decodes >= self.probe_period
            if collapse or probe:
                self._want_track = False
                self._stable = 0
                self._last_cur = None
                self._track_decodes = 0
        else:
            if self._last_cur is not None and (cur == self._last_cur).all():
                self._stable += 1
            else:
                self._stable = 0
            self._last_cur = cur.copy()
            if self._stable >= self.track_after and (d > 0).all():
                self._want_track = True
                self._entry_d = d.copy()
