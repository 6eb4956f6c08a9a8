"""The fleet's symbol ring and its hard-decision decode (the counterpart
of leansdr_tpu/fec/deconv_device.py).

`deconv_append` compacts demod output into a per-channel ring of
(symbol, cost) rows that the Viterbi decoder or `deconv_decode` drains
(JAX :152-269). Streams are [time, channel]; the append is one
per-channel cumsum and one scatter and never reads a value back to the
host.

`deconv_decode` is the algebraic deconvolution of deconvol_sync
(reference dvb.h:122-476) over every hypothesis at once (JAX :44-150,
:270-416): output bit (period p, polynomial b) is the GF(2) inner
product of a 64-bit window of the IQ bit stream with the deconvolution
polynomial, so the whole decode is one stride-2 convolution (one output
column per symbol offset, 2*punctperiod output features: the primary
and the alternate polynomials) followed by `& 1`. The 4 (rotation,
conjugation) sync maps and the punctweight/2 symbol alignments decode
side by side, and an argmin of the primary/alternate disagreement per
~4096-symbol sub-block elects the stream to emit (fastlock), or the
channel's `locked` hypothesis is kept (the reference's resync state
machine, driven from the host by `DeviceDeconvolver.next_sync`).

CUDA has no integer convolution: the port convolves float32 0/1 planes
with 0/1 taps (`F.conv1d`, TF32 off). Every partial sum is an integer of
at most 64, so the result is exact in any summation order. One sync map
is convolved at a time, which bounds the transient to [C, 2pp, T]
float32 (470 MB at the fleet's 7/8 shape); each map's primary bits are
kept packed, pp <= 7 of them to a byte.
"""

import threading
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from .. import device as _dev
from .deconv import TRACEBACK, deconv_spec, sync_maps

__all__ = ["DeconvPlan", "DeviceDeconvolver", "deconv_append",
           "deconv_decode", "make_plan"]

# Fleet drift window: channels whose fill lags the fleet maximum by more
# than DELTA_MAX symbols are dragged forward (see deconv_append).
DELTA_MAX = 256


def deconv_append(plan, state: dict, sym: torch.Tensor, valid: torch.Tensor,
                  cost: torch.Tensor | None = None) -> dict:
    """Compact new demod output into the ring.

    sym [n, C] u8, valid [n, C] bool, cost [n, C] i16 (with
    plan.store_costs). Returns the state dict with the new fill; the
    ring tensors state["buf"] / state["cost"] are updated IN PLACE (the
    JAX version returns new arrays; the port saves a ring copy per
    chunk).

    Ring contract (shared with the JAX version):
      * drift guard: fill = max(fill, max(fill) - (DELTA_MAX-1)), so a
        channel without a carrier (whose symbol count random-walks away
        from the fleet) is dragged forward instead of lagging without
        bound; the rows it skips hold whatever the ring held;
      * the valid symbols (and costs) land contiguously at the
        (dragged) fill, rows below it are untouched;
      * fill' = min(fill + nvalid, cap - DELTA_MAX - n);
      * rows at or past fill' hold garbage, which readers never look at
        (an underflowing decode is dropped by the host).
    """
    n, C = sym.shape
    fill = state["fill"]
    fill = torch.maximum(fill, fill.max() - (DELTA_MAX - 1))
    # Scan along time with time innermost: a scan over the outer dim of
    # [n, C] runs one sequential thread per channel on the GPU.
    csum = torch.cumsum(valid.t().to(torch.int32).contiguous(), dim=1,
                        dtype=torch.int32).t()
    nvalid = csum[-1]
    j = torch.arange(n, dtype=torch.int32, device=sym.device)[:, None]
    # Every source row gets its own slot in [fill, fill + n): valid rows
    # in stream order from fill, invalid rows after them (past the new
    # fill). Slots at or past the ring's end fold onto its last row,
    # which always lies past the new fill.
    row = torch.where(valid, fill + csum - 1, fill + nvalid + j - csum)
    row = row.clamp(max=plan.cap - 1).to(torch.int64)
    state["buf"].scatter_(0, row, sym.to(torch.uint8))
    if plan.store_costs:
        state["cost"].scatter_(0, row, cost.to(torch.int16))
    return dict(state, fill=(fill + nvalid).clamp(
        max=plan.cap - DELTA_MAX - n))


@dataclass(frozen=True)
class DeconvPlan:
    """Static geometry for one (rate, nchan, chunk) configuration."""
    rate: str
    nchan: int
    nsamp: int              # demod samples appended per call
    P_sub: int              # periods per election sub-block
    E: int                  # sub-blocks decoded per decode() call
    cap: int                # symbol ring capacity
    fastlock: bool
    store_costs = False     # hard decisions: the ring holds no costs

    @property
    def spec(self):
        return deconv_spec(self.rate)

    @property
    def A(self) -> int:     # symbol-alignment hypotheses per sync
        return self.spec.punctweight // 2

    @property
    def P_call(self) -> int:
        return self.E * self.P_sub

    @property
    def consumed(self) -> int:          # symbols consumed per decode()
        return self.P_call * self.spec.punctweight // 2

    @property
    def needed(self) -> int:            # symbols required before decode()
        return (self.consumed - self.spec.punctweight // 2
                + (self.A - 1) + TRACEBACK // 2)

    @property
    def nbytes(self) -> int:            # bytes emitted per decode()
        return self.P_call * self.spec.punctperiod // 8


def make_plan(rate: str, nchan: int, nsamp: int, omega: float,
              fastlock: bool = True, sub_symbols: int = 4096) -> DeconvPlan:
    """Size the decode call to just under the expected symbol production
    (nsamp/omega per call), as the JAX version does: sub-blocks of
    ~sub_symbols symbols, a multiple of 8 periods (byte-aligned), and a
    ring holding the pre-drain high-water mark plus one append."""
    pw = deconv_spec(rate).punctweight
    P_sub = max(8, int(sub_symbols * 2 / pw) // 8 * 8)
    prod = int(nsamp / omega)
    E = max(1, prod // (P_sub * pw // 2))
    plan = DeconvPlan(rate, nchan, nsamp, P_sub, E, 0, fastlock)
    cap = plan.needed + prod + nsamp + DELTA_MAX + 8192
    return DeconvPlan(rate, nchan, nsamp, P_sub, E, cap, fastlock)


@lru_cache(maxsize=None)
def _deconv_kernel(rate: str) -> np.ndarray:
    """[2*pp, 1, TRACEBACK] float32 conv1d weight (out, in, tap).

    Feature o < pp is primary polynomial deconv[pp-1-o] (the columns
    come out in the reference's emission order, dvb.h:379-382); features
    pp..2pp-1 are the alternates in the same order. Tap w multiplies
    stream bit 2t + w, which the window reads as polynomial bit
    TRACEBACK-1-w (the JAX kernel's [TRACEBACK, 1, 2pp], transposed).
    """
    spec = deconv_spec(rate)
    pp = spec.punctperiod
    k = np.zeros((2 * pp, 1, TRACEBACK), np.float32)
    for o in range(pp):
        for name, off in (("deconv", 0), ("deconv2", pp)):
            poly = getattr(spec, name)[pp - 1 - o]
            for w in range(TRACEBACK):
                k[o + off, 0, w] = (poly >> (TRACEBACK - 1 - w)) & 1
    return k


def _sym_to_iq_bits(win: torch.Tensor, s: int) -> torch.Tensor:
    """[S, C] u8 symbols -> [C, 2S] float32 IQ bits (I then Q per
    symbol) under sync map s. The maps are QPSK's: a symbol past 3 (a
    larger constellation's) reads as IQ bits 0, as the JAX version's
    select chain leaves it (leansdr_tpu/fec/deconv_device.py:134-149)."""
    lut = torch.zeros(256, dtype=torch.uint8, device=win.device)
    lut[:4] = torch.from_numpy(sync_maps()[s].astype(np.uint8))
    iq2 = lut[win.t().to(torch.int64)]                      # [C, S]
    bits = torch.stack([(iq2 >> 1) & 1, iq2 & 1], dim=-1)   # [C, S, 2]
    return bits.reshape(win.shape[1], -1).to(torch.float32)


_BYTE_WEIGHTS = (1 << np.arange(7, -1, -1)).astype(np.int32)


def deconv_decode(plan: DeconvPlan, state: dict, maps=None):
    """Decode plan.consumed symbols from the ring front (`maps` is
    unused: the sync maps are the four of `sync_maps()`).

    Returns (new_state, bytes [C, nbytes] u8, errs [C, E] i32 of the
    elected hypothesis per sub-block, underflow [C] bool), with no value
    read back. Hypothesis h = map * A + alignment; the election takes
    the first least count, as jnp.argmin does.
    """
    spec = plan.spec
    pp, A, E, P_sub = spec.punctperiod, plan.A, plan.E, plan.P_sub
    C, P = plan.nchan, plan.P_call
    S_need, S_call = plan.needed, plan.consumed
    buf = state["buf"]
    dev = buf.device
    underflow = state["fill"] < S_need
    win = buf[:S_need]
    weight = torch.from_numpy(_deconv_kernel(plan.rate)).to(dev)
    # 0/1 products summed to at most 64: exact in float32 in any order,
    # and in TF32 too; kept off as everywhere in the port.
    torch.backends.cudnn.allow_tf32 = False
    shifts = torch.arange(pp - 1, -1, -1, dtype=torch.uint8, device=dev)
    errs, dec = [], []
    for s in range(4):
        out = F.conv1d(_sym_to_iq_bits(win, s)[:, None, :], weight,
                       stride=2)[:, :, :P * A]             # [C, 2pp, P*A]
        bits = out.to(torch.uint8) & 1          # counts 0..64: exact
        prim, alt = bits[:, :pp], bits[:, pp:]
        errs.append((prim ^ alt).reshape(C, pp, E, P_sub, A)
                    .sum(dim=(1, 3), dtype=torch.int32))     # [C, E, A]
        dec.append((prim << shifts[None, :, None]).sum(
            dim=1, dtype=torch.uint8).reshape(C, E, P_sub, A))
        del out, bits, prim, alt
    errs_h = torch.stack(errs, dim=2).reshape(C, E, 4 * A)
    if plan.fastlock:
        elected = torch.argmin(errs_h, dim=2)                # [C, E]
        locked = elected[:, -1].to(torch.int32)
    else:
        locked = state["locked"]
        elected = locked.to(torch.int64)[:, None].expand(C, E)
    dec_h = torch.stack(dec, dim=3).reshape(C, E, P_sub, 4 * A)
    sel = torch.gather(dec_h, 3, elected[:, :, None, None].expand(
        C, E, P_sub, 1))[..., 0]                             # [C, E, P_sub]
    errs_sel = torch.gather(errs_h, 2, elected[:, :, None])[..., 0]
    stream = (sel[..., None] >> shifts) & 1                  # [.., pp]
    w = torch.from_numpy(_BYTE_WEIGHTS).to(dev)
    by = (stream.reshape(C, P * pp // 8, 8).to(torch.int32) * w).sum(
        dim=2, dtype=torch.int32).to(torch.uint8)            # [C, nbytes]
    new = dict(state, buf=torch.cat([buf[S_call:], torch.zeros(
        (S_call, C), dtype=torch.uint8, device=dev)]),
        fill=(state["fill"] - S_call).clamp(min=0), locked=locked)
    return new, by, errs_sel, underflow


class DeviceDeconvolver:
    """Stateful wrapper: symbol ring + all-hypothesis hard decode.

    Usage per chunk (device work only, no host sync between calls):
        dd.append(sym, valid)              # [nsamp, C] demod output
        dd.note_production(k)              # host-side fill estimate
        while dd.can_decode():
            bytes_d, errs_d, under_d = dd.decode()

    `next_sync(c)` (the byte backend's resync callback, run on its
    thread under MultiDvbsReceiver.submit) only queues the rotation; the
    queue is applied at the next `apply_pending_transition`, which
    dispatch() and decode() call first, so it never races with a
    dispatch that is rewriting the state.
    """

    kind = "deconv"
    maps = None

    def __init__(self, rate: str, nchan: int, nsamp: int, omega: float,
                 fastlock: bool = True, sub_symbols: int = 4096,
                 device=None):
        self.device = _dev.resolve_device(device)
        self.plan = make_plan(rate, nchan, nsamp, omega, fastlock,
                              sub_symbols)
        C, dev = nchan, self.device
        self.state = {
            "buf": torch.zeros((self.plan.cap, C), dtype=torch.uint8,
                               device=dev),
            "fill": torch.zeros(C, dtype=torch.int32, device=dev),
            "locked": torch.zeros(C, dtype=torch.int32, device=dev),
        }
        # Host-side conservative fill estimate (min over channels); the
        # true fill comes back with each decode fetch.
        self._est_fill = 0
        self._resyncs = []
        self._resync_lock = threading.Lock()

    @property
    def plan_dec(self):
        return self.plan

    def append(self, sym, valid, cost=None):
        self.state = deconv_append(self.plan, self.state, sym, valid, cost)

    def note_production(self, nsyms_min: int):
        """At least `nsyms_min` symbols per channel were appended."""
        self._est_fill += nsyms_min

    def sync_fill(self, fill: np.ndarray):
        """Replace the host estimate with fetched truth (min lane)."""
        self._est_fill = int(fill.min())

    def can_decode(self) -> bool:
        return self._est_fill >= self.plan.needed

    def decode(self):
        self.apply_pending_transition()
        self.state, by, errs, under = deconv_decode(self.plan, self.state)
        self._est_fill -= self.plan.consumed
        return by, errs, under

    def schedule_decode(self) -> int:
        """Bookkeeping-only equivalent of `while can_decode(): decode`:
        how many decodes the chunk's device work runs after its append."""
        k = 0
        while self.can_decode():
            self._est_fill -= self.plan.consumed
            k += 1
        return k

    def next_sync(self, channel: int):
        """Non-fastlock resync feedback from the MPEG framer (dvb.h:
        185-193): rotate the channel's sync map; after all 4, slip one
        symbol alignment. Queued; see the class docstring."""
        with self._resync_lock:
            self._resyncs.append(int(channel))

    def apply_pending_transition(self):
        """Apply the queued next_sync rotations to `locked`, in order: n
        rotations of hypothesis (s, a) give ((s + n) % 4,
        (a + (s + n) // 4) % A)."""
        with self._resync_lock:
            pending, self._resyncs = self._resyncs, []
        if not pending:
            return
        A = self.plan.A
        locked = self.state["locked"]
        n = torch.bincount(torch.tensor(pending, device=locked.device),
                           minlength=self.plan.nchan).to(torch.int32)
        t = locked // A + n
        self.state = dict(self.state,
                          locked=(t % 4) * A + (locked % A + t // 4) % A)
