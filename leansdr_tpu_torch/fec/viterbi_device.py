"""Multi-channel soft-decision Viterbi on the device: the ACS kernels
batched over channels x sync replicas, with sync election (the
counterpart of leansdr_tpu/fec/viterbi_device.py).

The rate-1/2 ACS lives here; the punctured rates (4/6, 3/4, 5/6, 7/8)
run the banked ACS of fec/viterbi_banked.py through
`viterbi_decode_banked`, with nshifts symbol-offset replicas per map.
Both feed the same election (`_elect_and_pack`).

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
from .viterbi_banked import bank_geometry, viterbi_acs_banked

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
        raise ValueError(f"rate {rate}: the punctured rates run the "
                         "banked ACS (fec/viterbi_banked.py)")
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
    # Replica structure: sync s = shift*(nconj*nrot) + map.
    nconj: int = 2
    nrot: int = 2

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


def _elect_and_pack(plan: ViterbiPlan, state: dict, us: torch.Tensor,
                    q: torch.Tensor, track_scale: int):
    """Sync election and byte packing of one decode.

    us/q [T, C, nsyncs] i32 from the ACS. Per-sub-block discriminant
    sums, with the strictly-greater switch applied AFTER each sub-block
    (dvb.h:1380-1412; the discr_delay skip of the first 64/bits_in blocks
    approximated at sub-block starts). In TRACK mode the tracked
    discriminant is scaled by `track_scale` (4 where the ACS subsampled
    q 1-in-4). Returns (bytes [C, nbytes] u8, discr [C, E+1] i32 with the
    elected sync index in the last column, the new current sync [C])."""
    C, E, T = plan.nchan, plan.E, plan.nblocks
    bits_in = make_trellis(plan.rate).bits_in
    dd = 64 // bits_in
    qsum = q.reshape(E, P_SUB, C, plan.nsyncs)[:, dd:].sum(
        dim=1, dtype=torch.int32)                             # [E, C, ns]
    if plan.nsyncs == 1:
        cur_out = state["current"]
        blocks = us.reshape(T, C).t()
        dsel = track_scale * qsum[:, :, 0].t()                # [C, E]
    else:
        cur = state["current"].to(torch.int64)
        elected = []
        for e in range(E):
            qk = qsum[e]                                      # [C, ns]
            best = torch.argmax(qk, dim=1)                    # first max
            bv = qk.gather(1, best[:, None])[:, 0]
            cv = qk.gather(1, cur[:, None])[:, 0]
            elected.append(cur)                               # pre-update
            cur = torch.where(bv > cv, best, cur)
        cur_out = cur.to(torch.int32)
        elected = torch.stack(elected)                        # [E, C]
        use = us.reshape(E, P_SUB, C, plan.nsyncs)
        sel = use.gather(3, elected[:, None, :, None].expand(
            E, P_SUB, C, 1))[..., 0]
        blocks = sel.reshape(T, C).t()                        # [C, T]
        dsel = qsum.gather(2, elected[:, :, None])[:, :, 0].t()
    # bits_in bits per block, MSB first, packed to bytes.
    shifts = torch.arange(bits_in - 1, -1, -1, dtype=torch.int32,
                          device=us.device)
    bits = ((blocks[:, :, None] >> shifts) & 1).reshape(C, T * bits_in)
    w = torch.from_numpy(_BYTE_WEIGHTS).to(us.device)
    by = (bits.reshape(C, T * bits_in // 8, 8) * w).sum(
        dim=2, dtype=torch.int32).to(torch.uint8)
    dsel = torch.cat([dsel.to(torch.int32),
                      (state["tsync"] if plan.nsyncs == 1
                       else cur_out)[:, None]], 1)
    return by, dsel, cur_out


def _ring_advance(plan: ViterbiPlan, state: dict) -> dict:
    """Drop the decode's consumed symbols from the ring front."""
    Sc, C = plan.consumed, plan.nchan
    dev = state["buf"].device
    return dict(
        buf=torch.cat([state["buf"][Sc:], torch.zeros(
            (Sc, C), dtype=torch.uint8, device=dev)]),
        cost=torch.cat([state["cost"][Sc:], torch.zeros(
            (Sc, C), dtype=torch.int16, device=dev)]),
        fill=(state["fill"] - Sc).clamp(min=0))


def viterbi_decode(plan: ViterbiPlan, state: dict, maps):
    """Decode plan.nblocks rate-1/2 FEC blocks from the ring front.

    Returns (new_state, bytes [C, nbytes] u8, discr [C, E+1] i32 for the
    elected sync with the elected sync index in the last column,
    underflow [C] bool). Stays on the device: no value is read back.
    """
    C, T = plan.nchan, plan.nblocks
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
    else:
        cs = maps_arr[:, sym].permute(1, 2, 0)                # [T, C, 4]
        costf = cost_b[:, :, None].expand(T, C, NSYNCS)
    csf = cs.reshape(T, plan.n_lanes).contiguous()
    costf = costf.reshape(T, plan.n_lanes).contiguous()

    m2, p2, us, q = viterbi_acs(plan.rate, state["metric"], state["path"],
                                csf, costf, cheap_q=track)
    # cheap_q subsampled q 1-in-4 in TRACK: rescale to full-sum units so
    # the watchdog threshold (entered from ACQUIRE) still holds.
    by, dsel, cur_out = _elect_and_pack(
        plan, state, us.reshape(T, C, plan.nsyncs),
        q.reshape(T, C, plan.nsyncs), track_scale=4)
    new = dict(state, **_ring_advance(plan, state), metric=m2, path=p2,
               current=cur_out)
    return new, by, dsel, underflow


def _punctured_block_inputs(plan: ViterbiPlan, maps, win_sym, win_cost):
    """Per-replica trellis-block inputs for the punctured rates
    (dvb.h:1353-1363): block b of sync s = shift*M + map reads symbols
    [b*ns + shift, +ns), maps them, concatenates label bits and sums
    costs. win_sym/win_cost [needed, C] integer. Returns
    (cs [T, C, nsyncs] i32, cost [T, C, nsyncs] i32)."""
    bps = make_trellis(plan.rate).bits_out // plan.nshifts
    ns, T = plan.nshifts, plan.nblocks
    M = plan.nconj * plan.nrot
    maps_arr = torch.tensor(maps, dtype=torch.int32, device=win_sym.device)
    msym = maps_arr[:, win_sym.to(torch.int64)]              # [M, need, C]
    cost32 = win_cost.to(torch.int32)
    cs_parts, cost_parts = [], []
    for sh in range(ns):
        cs_b = torch.zeros_like(msym[:, :T])
        cost_b = torch.zeros_like(cost32[:T])
        for i in range(ns):
            rows = slice(sh + i, sh + i + (T - 1) * ns + 1, ns)
            cs_b = (cs_b << bps) | msym[:, rows]
            cost_b = cost_b + cost32[rows]
        cs_parts.append(cs_b)                                 # [M, T, C]
        cost_parts.append(cost_b)                             # [T, C]
    cs = torch.cat(cs_parts).permute(1, 2, 0)                 # [T, C, ns*M]
    cost = torch.stack(cost_parts).repeat_interleave(M, dim=0)
    return cs, cost.permute(1, 2, 0)


def _punctured_block_inputs_tracked(plan: ViterbiPlan, maps, win_sym,
                                    win_cost, tsync):
    """TRACK-mode block inputs: only each channel's ELECTED sync replica
    (tsync = shift*M + map) is materialized, gathered at its own symbol
    shift. Returns (cs [T, C] i32, cost [T, C] i32)."""
    bps = make_trellis(plan.rate).bits_out // plan.nshifts
    ns, T = plan.nshifts, plan.nblocks
    M = plan.nconj * plan.nrot
    dev = win_sym.device
    maps_arr = torch.tensor(maps, dtype=torch.int32, device=dev)
    ts = tsync.to(torch.int64)
    mapped = maps_arr[ts % M].t().gather(0, win_sym.to(torch.int64))
    cost32 = win_cost.to(torch.int32)
    first = (torch.arange(T, device=dev)[:, None] * ns
             + (ts // M)[None, :])                            # [T, C]
    cs = torch.zeros(first.shape, dtype=torch.int32, device=dev)
    cost = torch.zeros_like(cs)
    for i in range(ns):
        cs = (cs << bps) | mapped.gather(0, first + i)
        cost = cost + cost32.gather(0, first + i)
    return cs, cost


def viterbi_decode_banked(plan: ViterbiPlan, state: dict, maps):
    """Punctured-rate fleet decode on the banked ACS
    (fec/viterbi_banked.py, csrc/acs_banked.cu): rates with nshifts > 1
    (4/6, 3/4, 5/6, 7/8; 2/3 runs as 4/6).

    State planes metric/path_hi/path_lo are [64, C*nsyncs] in stored-row
    order (lane = c*nsyncs + s). plan.nsyncs == 1 selects TRACK mode:
    only each channel's elected sync replica advances (map and symbol
    shift chosen per channel from state["tsync"]), with the full
    per-block discriminant. Returns (new_state, bytes [C, nbytes] u8,
    discr [C, E+1] i32, underflow [C] bool), with no value read back.
    """
    C, T = plan.nchan, plan.nblocks
    underflow = state["fill"] < plan.needed
    win_sym = state["buf"][:plan.needed]
    win_cost = state["cost"][:plan.needed]
    if plan.nsyncs == 1:
        cs, cost = _punctured_block_inputs_tracked(
            plan, maps, win_sym, win_cost, state["tsync"])
    else:
        cs, cost = _punctured_block_inputs(plan, maps, win_sym, win_cost)
    cs = cs.reshape(T, plan.n_lanes).contiguous()
    cost = cost.reshape(T, plan.n_lanes).contiguous()
    m2, h2, l2, us, q = viterbi_acs_banked(
        plan.rate, state["metric"], state["path_hi"], state["path_lo"],
        cs, cost)
    by, dsel, cur_out = _elect_and_pack(
        plan, state, us.reshape(T, C, plan.nsyncs),
        q.reshape(T, C, plan.nsyncs), track_scale=1)
    new = dict(state, **_ring_advance(plan, state), metric=m2, path_hi=h2,
               path_lo=l2, current=cur_out)
    return new, by, dsel, underflow


def decoder(kind: str):
    """The fleet decode function of MultiViterbiSync.kind. Looked up at
    call time, so a caller that rebinds the module attribute (e.g. to
    time it) is the one that runs."""
    return {"viterbi": viterbi_decode,
            "viterbi_banked": viterbi_decode_banked}[kind]


def _planes_to_track(plane, current, C: int, nsyncs: int):
    """Keep each channel's elected sync replica lane of a [64, C*nsyncs]
    trellis plane (lane = c*nsyncs + s)."""
    cols = (torch.arange(C, device=plane.device) * nsyncs
            + current.to(torch.int64))
    return plane[:, cols].contiguous()


def _planes_to_acquire(plane, C: int, nsyncs: int):
    """Seed all replicas from the tracked lane (they diverge within one
    traceback depth, like the reference's fresh replicas)."""
    return plane[:, :C].repeat_interleave(nsyncs, dim=1).contiguous()


class MultiViterbiSync:
    """N-channel viterbi_sync: symbol+cost ring -> ACS kernel over all
    sync replicas -> elected bit stream, packed to bytes on the device.

    QPSK-class constellations (4 maps) at rate 1/2 (`kind` "viterbi":
    csrc/acs.cu) and at the punctured rates 4/6, 3/4, 5/6 and 7/8
    (`kind` "viterbi_banked": csrc/acs_banked.cu, nshifts symbol-offset
    replicas per map). `fastlock` is accepted for interface parity:
    replicas are always on, so both modes use the same election.
    """

    def __init__(self, cstln, rate: str, nchan: int, nsamp: int,
                 omega: float, fastlock: bool = True, device=None):
        maps, nconj, nrot, nshifts = make_sync_maps(cstln, rate)
        if nconj * nrot != NSYNCS:
            raise NotImplementedError(
                f"rate {rate} on {cstln.name}: the fleet Viterbi on "
                "constellations other than QPSK is ROADMAP queue 1 item 20")
        if make_trellis(rate).bits_in > 1:
            bank_geometry(rate)
            self.kind = "viterbi_banked"
        else:
            _butterfly_tables(rate)
            self.kind = "viterbi"
        self.device = _dev.resolve_device(device)
        self.maps = tuple(tuple(int(v) for v in row) for row in maps)
        prod = int(nsamp / omega)
        E = max(1, prod // (P_SUB * nshifts))
        cap = E * P_SUB * nshifts + prod + nsamp + DELTA_MAX + 8192
        nsyncs = nconj * nrot * nshifts
        self.plan = ViterbiPlan(rate, nchan, nsamp, nshifts, E, cap,
                                nsyncs=nsyncs, nconj=nconj, nrot=nrot)
        self.plan_track = ViterbiPlan(rate, nchan, nsamp, nshifts, E, cap,
                                      nsyncs=1, nconj=nconj, nrot=nrot)
        C = nchan
        dev = self.device
        i32 = dict(dtype=torch.int32, device=dev)
        self.state = {
            "buf": torch.zeros((cap, C), dtype=torch.uint8, device=dev),
            "cost": torch.zeros((cap, C), dtype=torch.int16, device=dev),
            "fill": torch.zeros(C, **i32),
            "current": torch.zeros(C, **i32),
            "tsync": torch.zeros(C, **i32),
        }
        for k in self.plane_keys:
            self.state[k] = torch.zeros((64, self.plan.n_lanes), **i32)
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

    @property
    def plane_keys(self) -> tuple:
        """The trellis planes of the state dict, each [64, lanes] i32."""
        return (("metric", "path_hi", "path_lo")
                if self.kind == "viterbi_banked" else ("metric", "path"))

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
        C, nsyncs = self.plan.nchan, self.plan.nsyncs
        st = self.state
        if self._want_track:
            planes = {k: _planes_to_track(st[k], st["current"], C, nsyncs)
                      for k in self.plane_keys}
            self.state = dict(st, **planes, tsync=st["current"])
        else:
            planes = {k: _planes_to_acquire(st[k], C, nsyncs)
                      for k in self.plane_keys}
            self.state = dict(st, **planes, current=st["tsync"])
        self.track = self._want_track

    def decode(self):
        self.apply_pending_transition()
        plan = self.plan_dec
        self.state, by, discr, under = decoder(self.kind)(plan, self.state,
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
