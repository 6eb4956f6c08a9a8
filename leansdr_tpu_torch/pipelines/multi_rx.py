"""Multi-carrier DVB-S receiver: many independent carriers demodulated and
decoded in one device batch (the counterpart of
leansdr_tpu/pipelines/multi_rx.py).

Chain per chunk, all on the device until one packed fetch:

  [host-side preprocessing with anf / cnr / want_spectrum
   (dsp/blocks_device, as the JAX fleet runs it, leansdr_tpu/pipelines/
   multi_rx.py:766-831): the auto-notch on the [C, n, 2] planes (cuFFT
   detection, device trackers), then the CNR estimator (the carrier
   from the demod state's freqw / 65536) and the spectrum, one cuFFT
   of one block per Fs samples each; into `cnr` and `spectrum_lines`]
    -> [matched filter (dsp/mf_prefilter.py), with sampler="rrc" and
   computed decisions; the linear sampler reads the input as it is]
    -> the demod, one launch per chunk, or with `segments=S` two
       launches over S lanes per carrier (the time-segmented demod,
       `_demod_segmented`), on one of two routes:
         the demod kernel (csrc/demod.cu: PLL + M&M timing + computed
           soft demap; state as [19, C] planes);
         the scan demod (dsp/receiver.run_chunks on csrc/scan_demod.cu)
           with exact_lut=True (the trig16 table and the 256x256 LUT;
           sampler="rrc": the polyphase fir_sampler in the loop),
           sampler="nearest" or use_pallas=False (state as JAX's dict)
    -> symbol ring append (fec/deconv_device.py: cumsum + scatter)
    -> with viterbi=True, soft Viterbi over the sync replicas with
       election, at every constellation and rate:
         QPSK-class rate 1/2, 4 replicas: csrc/acs.cu inside
           fec/viterbi_device.viterbi_decode;
         every other (constellation, rate), 2/3 run as "4/6":
           nmaps x nshifts replicas (up to 32), block inputs ->
           csrc/acs_banked.cu inside
           fec/viterbi_device.viterbi_decode_banked;
       with viterbi=False, hard decisions: the all-hypothesis GF(2)
       decode of fec/deconv_device.deconv_decode (QPSK's 4 sync maps,
       symbols past 3 read as 0 as in the JAX fleet, x the
       symbol alignments, elected per sub-block with fastlock, else the
       channel's locked hypothesis, rotated by the framer's resyncs)
    -> ONE packed u8 buffer per chunk (bytes | discriminants or
       disagreement counts | underflow per decode, then the ring fill)
  host: the byte backend: MPEG framing, deinterleave, RS(204,188),
        derandomize -> TS packets per channel; the C++ one (native/)
        by default, `_ByteBackend` (NumPy) with native=False.

The decode schedule is decided on the host from conservative fill
bookkeeping, so the device work of a chunk needs no host sync.
"""

import pickle

import numpy as np
import torch

from .. import device as _dev
from ..dsp import blocks_device as bd
from ..dsp import mf_prefilter, receiver
from ..dsp import receiver_kernel as rk
from ..dsp.cstln import make_dvbs2_constellation
from ..fec import interleave, prbs, rs
from ..fec.deconv import deconv_spec
from ..fec.deconv_device import DeviceDeconvolver, deconv_append
from ..fec.viterbi import make_sync_maps
from ..fec.viterbi_banked import fleet_rate
from ..fec.viterbi_device import MultiViterbiSync, decoder
from ..native import NativeByteBackend
from ..proto.framing import RS_SIZE, MpegSync
from ..util import trace
from .dvbs_rx import (RxConfig, TS_SIZE, TsStages, _DeconvolSync,
                      rrc_sampler, state_from_numpy, state_to_numpy)

CHECKPOINT_FORMAT = "leansdr_tpu_torch.multi_rx/1"


def _pack_fetch(fill: torch.Tensor, flat: list) -> torch.Tensor:
    """Concatenate the chunk's decode results + the fill watermark into
    ONE u8 [C, total] tensor, so the host pays a single transfer.

    flat: triples (bytes [C,NB] u8, errs [C,E'] i32, under [C] bool),
    E' = E + 1 for the Viterbi kinds (the elected sync last), E for the
    hard decode. Layout per channel row: nd x [NB bytes | E'*4 errs |
    1 under] | 4 fill
    (little-endian, the byte layout of the JAX version).
    """
    C = fill.shape[0]
    parts = []
    for i in range(0, len(flat), 3):
        by, errs, under = flat[i:i + 3]
        parts += [by, errs.contiguous().view(torch.uint8).reshape(C, -1),
                  under.to(torch.uint8)[:, None]]
    parts.append(fill.to(torch.int32)[:, None].contiguous()
                 .view(torch.uint8))
    return torch.cat(parts, dim=1)


def _extract_sym_valid(packed: torch.Tensor):
    """Demod output [nsamp, C] i32 -> (sym u8, valid bool, cost i16)."""
    sym = ((packed >> 16) & 0xFF).to(torch.uint8)
    valid = ((packed >> 24) & 1).to(torch.bool)
    cost = (-(packed & 0xFFFF)).to(torch.int16)
    return sym, valid, cost


def _wrap_u16(p):
    """Wrap a u16-unit angle (65536 = 2*pi) into [0, 65536)."""
    return p - torch.floor(p / 65536.0) * 65536.0


_SEG_T = 128    # boundary overlap window (rows, a multiple of CHUNK)


def seg_positions(S: int, nseg: int, T: int = _SEG_T):
    """End-of-chunk stream positions of the S persisted segment states,
    relative to the NEXT chunk's head (all <= 0). Segment 0's emit
    window is [0, nseg+T); segment s>=1's is [s*nseg-T, (s+1)*nseg)."""
    n = S * nseg
    return [nseg + T - n] + [(j + 1) * nseg - n for j in range(1, S)]


# The demod state of either route: [NSTATE, lanes] planes (the demod
# kernel) or the scan demod's dict of [lanes, ...] tensors.

def _lanes(st, lo: int, hi: int):
    if isinstance(st, dict):
        return {k: v[lo:hi] for k, v in st.items()}
    return st[:, lo:hi]


def _cat(a, b):
    if isinstance(a, dict):
        return {k: torch.cat([a[k], b[k]]) for k in a}
    return torch.cat([a, b], dim=1)


def nlanes(st) -> int:
    return st["mu"].shape[0] if isinstance(st, dict) else st.shape[1]


def _freqw(st):
    return st["freqw"] if isinstance(st, dict) else st[2]


def _phase(st):
    return st["phase"] if isinstance(st, dict) else st[1]


def _with_phase(st, phase):
    if isinstance(st, dict):
        return dict(st, phase=phase)
    st = st.clone()
    st[1] = phase
    return st


def demod(params, sym_consts, tables, st, x):
    """One demod launch over x [lanes, n + readahead, 2] from either
    route's state. Returns (state, sym [n, lanes] u8, valid bool, cost
    i16)."""
    if isinstance(st, dict):
        st, out = receiver.run_chunks(params, tables, st, x)
        return st, out["symbol"].T, out["valid"].T, out["cost"].T
    st, packed = rk.demod(params, sym_consts, st, x.contiguous())
    return (st,) + _extract_sym_valid(packed)


def init_seg_state(dem_state, nchan: int, S: int, nseg: int,
                   T: int = _SEG_T):
    """Cold-start per-segment persisted state: the carried chunk-head
    state of C lanes replicated into S*C lanes (lane s*C + c) positioned
    at seg_positions(S, nseg), with the lock phase advanced by freqw x
    position, so the first segmented chunk's pass-1 seeding is exactly a
    prediction from the chunk head, and every later chunk's a one-chunk
    advance of each segment's own trajectory. Planes [NSTATE, C] give
    [NSTATE, S*C]; a scan dict gives the dict of S*C lanes."""
    C = nchan
    head = _lanes(dem_state, 0, C)
    pos = torch.tensor(seg_positions(S, nseg, T), dtype=torch.float32,
                       device=_freqw(head).device).repeat_interleave(C)
    if isinstance(head, dict):
        rep = {k: torch.cat([v] * S) for k, v in head.items()}
    else:
        rep = head.repeat(1, S)
    adv = _wrap_u16(_wrap_u16(_freqw(rep) * 128.0) * (pos / 128.0))
    return _with_phase(rep, _wrap_u16(_phase(rep) + adv))


def _rot_label(sb: torch.Tensor, r):
    """The QPSK label permutation for a lock offset of r*90 degrees, as
    branchless bit algebra on labels b1b0 = (i_neg, q_neg). r is an int
    or a [C] row of ints."""
    s_ = sb.to(torch.int32)
    forms = (s_,
             2 + (s_ >> 1) - 2 * (s_ & 1),      # [2,0,3,1]  +90
             3 - s_,                            # [3,2,1,0]  180
             1 - (s_ >> 1) + 2 * (s_ & 1))      # [1,3,0,2]  -90
    if isinstance(r, int):
        return forms[r].to(torch.uint8)
    rh = r[None, :]
    out = forms[0]
    for k in (1, 2, 3):
        out = torch.where(rh == k, forms[k], out)
    return out.to(torch.uint8)


def _demod_segmented(params, sym_consts, mf_taps, nchan, S, W, want_cost,
                     dem_state, seg_state, x, tables=None):
    """Two-pass time-segmented demod with per-segment persistent state
    (the counterpart of leansdr_tpu/pipelines/multi_rx.py:109-401): each
    carrier's chunk is split into S time segments demodulated in
    parallel kernel lanes (lane l = s*C + c), which widens the demod
    kernel's launch from C to S*C threads.

    pass 1 (precursor): S-1 windows of W samples, window j ending exactly
      where segment j+1's emit window starts. Lane j is seeded from
      segment j's own persisted end-of-previous-chunk state (`seg_state`)
      with the lock phase advanced by freqw x gap; only each lane's end
      state is kept.
    pass 2 (emit): segment 0 continues the carried chunk-head state
      `dem_state`; segment s>=1 starts from pass-1 lane s-1's end state.
      Each lane's matched filter tracks its own freqw.

    Each boundary is cut inside a T-row overlap window at the first row
    where both trajectories emit the same symbol (rows offset by at most
    one), falling back to the blind cut. A segment whose PLL locked a
    QPSK quadrant away is relabelled (the rotation estimated from
    decision agreement in the overlap window) and its persisted phase
    derotated. Every float step is in the JAX version's order.

    The demod is the demod kernel on planes (dem_state [NSTATE, C],
    seg_state [NSTATE, S*C]) or the scan demod on its dicts of C and S*C
    lanes (with its `tables`), as the JAX engine takes either. x [C, n +
    readahead, 2] with n a multiple of S*CHUNK. Returns (dem_state,
    seg_state, sym [n, C] u8, valid [n, C] bool, cost [n, C] i16 or
    None).
    """
    C = nchan
    T = _SEG_T
    J = (S - 1) * C                      # precursor lanes
    dev = x.device
    ra = params.readahead + (len(mf_taps) - 1 if mf_taps is not None else 0)
    n = x.shape[1] - ra
    nseg = n // S
    if nseg < W + T:
        raise ValueError(
            f"chunk/segments = {nseg} < warmup+overlap {W + T}")
    L2 = nseg + T                        # emit window rows
    # Persisted segment j sits at pos[j] (<= 0, relative to this chunk's
    # head); precursor window j is [b_j, b_j + W), ending exactly at emit
    # window j+1's start. Gaps are multiples of 128, so the two-step
    # wrap below is exact in float32.
    pos = seg_positions(S, nseg, T)
    b = [(j + 1) * nseg - T - W for j in range(S - 1)]
    gapv = torch.tensor([b[j] - pos[j] for j in range(S - 1)],
                        dtype=torch.float32, device=dev).repeat_interleave(C)
    xs1 = torch.stack([x[:, bj:bj + W + ra] for bj in b]).reshape(
        J, W + ra, 2)
    offs2 = [0] + [s * nseg - T for s in range(1, S)]
    xs2 = torch.stack([x[:, o:o + L2 + ra] for o in offs2]).reshape(
        S * C, L2 + ra, 2)

    def mf(freqw, xs):
        if mf_taps is None:
            return xs
        return mf_prefilter.mf_prefilter(mf_taps, freqw, xs)

    # -- pass 1: precursor windows from the persisted per-segment states
    p1 = _lanes(seg_state, 0, J)
    adv = _wrap_u16(_wrap_u16(_freqw(p1) * 128.0) * (gapv / 128.0))
    p1 = _with_phase(p1, _wrap_u16(_phase(p1) + adv))
    st1 = demod(params, sym_consts, tables, p1, mf(_freqw(p1), xs1))[0]
    # -- pass 2: emit windows; lane 0 = the carried chunk-head state, lane
    # s>=1 = pass-1 lane s-1's exactly positioned end state.
    p2 = _cat(dem_state, st1)
    seg_out, sym, valid, cost = demod(params, sym_consts, tables, p2,
                                      mf(_freqw(p2), xs2))  # [L2, S*C]

    # Local rows per segment: segment 0 owns [0, nseg) ([nseg, L2) is
    # padding for window uniformity); segment s>=1 has its boundary
    # prefix in [0, T) and owns [T, L2). The overlap at boundary s is lane
    # s-1's owned tail against lane s's prefix.
    def seg_of(a, s):
        return a[:, s * C:(s + 1) * C]

    def owned_rows(s):
        lo = 0 if s == 0 else T
        return lo, lo + nseg

    def tail_rows(s):
        return (nseg - T, nseg) if s == 0 else (nseg, L2)

    # Rotation: perms[r] maps the incoming trajectory's labels into the
    # outgoing frame for a lock offset of r*90 degrees; rhat per carrier
    # is the r under which the overlap window's decisions agree most
    # (argmax takes the first maximum), kept at 0 without T//8 agreeing
    # emissions. Handover: the cut is the row after both copies of the
    # first anchor symbol emitted by both trajectories at rows at most
    # one apart:
    #   case0  a and b emit at w        -> cut w+1
    #   case1  a at w, b at w+1         -> cut w+2, a silent at w+1
    #   case2  a at w+1, b at w         -> cut w+2, b silent at w+1
    # Rows < cut come from the outgoing trajectory; no anchor -> cut T.
    qpsk = params.nsymbols == 4
    dphase = torch.tensor([0.0, 16384.0, 32768.0, -16384.0],
                          dtype=torch.float32, device=dev)
    sym_corr = [seg_of(sym, 0)]
    masks = []
    seg_rot = [torch.zeros(C, dtype=torch.float32, device=dev)]
    rows = torch.arange(T, device=dev)[:, None]
    for s in range(1, S):
        ta, tb = tail_rows(s - 1)
        va = seg_of(valid, s - 1)[ta:tb]
        sa = sym_corr[s - 1][ta:tb]
        vb = seg_of(valid, s)[:T]
        sb_raw = seg_of(sym, s)
        if qpsk:
            cnt = []
            for r in range(4):
                sbr = _rot_label(sb_raw[:T], r)
                m = (va[:-1] & vb[:-1] & (sa[:-1] == sbr[:-1])) \
                    | (va[:-1] & vb[1:] & (sa[:-1] == sbr[1:])) \
                    | (va[1:] & vb[:-1] & (sa[1:] == sbr[:-1]))
                cnt.append(m.sum(dim=0))
            cnt = torch.stack(cnt)                     # [4, C]
            rhat = torch.argmax(cnt, dim=0)
            rhat = torch.where(cnt.amax(dim=0) >= T // 8, rhat,
                               torch.zeros_like(rhat))
            sseg = _rot_label(sb_raw, rhat)
            # rhat maps segment s's raw labels into the base frame, so it
            # is also the segment's lock-phase offset against the stream.
            seg_rot.append(dphase[rhat])
        else:
            sseg = sb_raw
            seg_rot.append(seg_rot[0])
        sym_corr.append(sseg)
        sb = sseg[:T]
        c0 = va[:-1] & vb[:-1] & (sa[:-1] == sb[:-1])        # [T-1, C]
        c1 = va[:-1] & vb[1:] & (sa[:-1] == sb[1:]) & ~va[1:]
        c2 = va[1:] & vb[:-1] & (sa[1:] == sb[:-1]) & ~vb[1:]
        anyc = c0 | c1 | c2
        first = torch.argmax(anyc.to(torch.int32), dim=0)    # first True
        same_row = torch.gather(c0, 0, first[None])[0]
        cut = torch.where(same_row, first + 1, first + 2)
        cut = torch.where(anyc.any(dim=0), cut, torch.full_like(cut, T))
        masks.append(rows >= cut[None, :])

    # Derotate every persisted segment's lock phase into the stream frame
    # (segment S-1's state is also the next chunk's exact segment-0 seed).
    if qpsk:
        seg_out = _with_phase(seg_out,
                              _wrap_u16(_phase(seg_out) - torch.cat(seg_rot)))
    dem_state = _lanes(seg_out, (S - 1) * C, S * C)
    if not isinstance(dem_state, dict):
        dem_state = dem_state.contiguous()

    def splice(a, segs=None):
        get = segs.__getitem__ if segs else (lambda s: seg_of(a, s))
        out = torch.cat([get(s)[slice(*owned_rows(s))] for s in range(S)])
        for s in range(1, S):
            ta, tb = tail_rows(s - 1)
            out[s * nseg - T:s * nseg] = torch.where(
                masks[s - 1], get(s)[:T], get(s - 1)[ta:tb])
        return out

    return (dem_state, seg_out, splice(sym, sym_corr), splice(valid),
            splice(cost) if want_cost else None)


def _fused_chunk(params, sym_consts, mf_taps, kind, plan, plan_dec, maps,
                 schedule, dem_state, seg_state, dstate, x, segments=1,
                 seg_warmup=2048, tables=None):
    """One chunk of device work: [matched filter, when mf_taps is not
    None] -> the demod (the demod kernel on planes, or the scan demod on
    its dict with `tables`; the segmented demod when segments > 1) ->
    sym/valid(/cost for the Viterbi kinds) extraction -> ring append(s)
    -> `schedule` decodes (the decoder of `kind`) -> the packed fetch
    buffer. Plain eager PyTorch around the kernels. Returns (dem_state,
    seg_state, dstate, packed_out)."""
    decode = decoder(kind)
    want_cost = kind.startswith("viterbi")
    if segments > 1:
        with trace.span("fleet.segmented"):
            dem_state, seg_state, sym, valid, cost = _demod_segmented(
                params, sym_consts, mf_taps, nlanes(dem_state), segments,
                seg_warmup, want_cost, dem_state, seg_state, x,
                tables=tables)
    else:
        if mf_taps is not None:
            with trace.span("fleet.mf"):
                x = mf_prefilter.mf_prefilter(mf_taps, _freqw(dem_state), x)
        with trace.span("fleet.demod"):
            dem_state, sym, valid, cost = demod(params, sym_consts, tables,
                                                dem_state, x)
        if not want_cost:
            cost = None
    n = sym.shape[0]
    step = plan.nsamp
    flat = []
    for i, o in enumerate(range(0, n, step)):
        m = min(step, n - o)
        with trace.span("fleet.ring_append"):
            dstate = deconv_append(plan, dstate, sym[o:o + m],
                                   valid[o:o + m],
                                   None if cost is None else cost[o:o + m])
        for _ in range(schedule[i]):
            with trace.span("fleet.decode"):
                dstate, by, errs, under = decode(plan_dec, dstate, maps)
            flat += [by, errs, under]
    with trace.span("fleet.pack"):
        packed = _pack_fetch(dstate["fill"], flat)
    return dem_state, seg_state, dstate, packed


def _check_config(cfg: RxConfig, segments, seg_warmup):
    """Raise for an invalid setting, before any device is asked for:
    the combinations of constellation and rate the JAX fleet
    refuses raise its errors (make_dvbs2_constellation's and
    make_sync_maps' ValueError; the hard decoder's KeyError at 4/5)."""
    cstln = make_dvbs2_constellation(cfg.constellation, cfg.rate)
    if cfg.viterbi:
        make_sync_maps(cstln, fleet_rate(cfg.rate))
    else:
        deconv_spec(fleet_rate(cfg.rate))
    if segments < 1:
        raise ValueError("segments must be >= 1")
    if seg_warmup % receiver.CHUNK:
        raise ValueError(f"seg_warmup must be a multiple of {receiver.CHUNK}")
    if cfg.exact_lut is None:
        raise ValueError("RxConfig.exact_lut must be given explicitly "
                         "(False: computed decisions)")
    if cfg.sampler not in ("nearest", "linear", "rrc"):
        raise ValueError(f"sampler={cfg.sampler!r}: nearest, linear or rrc")


class _ByteChain(TsStages):
    """One candidate's host byte chain: deconv -> MPEG sync -> deinterleave
    -> RS -> derandomize (a copy of leansdr_tpu/pipelines/multi_rx.py
    `_ByteChain`), the TS stages DvbsReceiver's (TsStages). The
    candidate-scan receiver (pipelines/scan_rx.py) keeps one per
    candidate."""

    def __init__(self, rate: str, fastlock: bool):
        self.deconv = _DeconvolSync(rate, fastlock)
        self._ts_init(MpegSync(fastlock=fastlock,
                               on_next_sync=self.deconv.next_sync))

    def feed(self, syms: np.ndarray) -> np.ndarray:
        """Hard symbols -> the TS packets [n, 188] they end."""
        return self._ts_stages(self.deconv.process(syms))[0]


class _ByteBackend:
    """Host byte-domain stages for one channel fleet in NumPy (a copy of
    leansdr_tpu/pipelines/multi_rx.py `_ByteBackend`): per channel MPEG
    framing and deinterleave, one batched RS decode for the fleet, then
    derandomize. Same feed/locks/vbitcount/verrcount and save/restore
    contract as NativeByteBackend; its blob is the JAX class's, so a JAX
    receiver's Python-backend checkpoint restores here."""

    def __init__(self, nchan: int, fastlock: bool, on_next_sync=None):
        self.nchan = nchan
        # Warm the RS tables and the correction path so the first
        # streaming chunk does not pay their one-time build cost.
        rs.gf2_syndrome_matrix()
        warm = rs.encode(np.zeros((96, TS_SIZE), np.uint8))
        warm[:, 3] ^= 0x5A
        rs.decode(warm)
        self.mpeg = [
            MpegSync(fastlock=fastlock,
                     on_next_sync=(None if on_next_sync is None
                                   else (lambda c=c: on_next_sync(c))))
            for c in range(nchan)]
        self.byte_backlog = [np.empty(0, np.uint8) for _ in range(nchan)]
        self.mpegbyte_backlog = [np.empty(0, np.uint8)
                                 for _ in range(nchan)]
        self.derand_pos = [0] * nchan
        self.vbitcount = np.zeros(nchan, np.int64)
        self.verrcount = np.zeros(nchan, np.int64)

    def feed(self, bytes_by_chan) -> list:
        """bytes_by_chan: per-channel new byte arrays (possibly empty).
        Returns per-channel TS packet arrays [k, 188]."""
        C = self.nchan
        rspkts = []
        counts = []
        for c in range(C):
            b = bytes_by_chan[c]
            if len(b):
                self.byte_backlog[c] = np.concatenate(
                    [self.byte_backlog[c], b])
            pkts, consumed = self.mpeg[c].process(self.byte_backlog[c])
            self.byte_backlog[c] = self.byte_backlog[c][consumed:]
            if len(pkts):
                self.mpegbyte_backlog[c] = np.concatenate(
                    [self.mpegbyte_backlog[c], pkts.reshape(-1)])
            rp, self.mpegbyte_backlog[c] = interleave.deinterleave(
                self.mpegbyte_backlog[c])
            rspkts.append(rp)
            counts.append(rp.shape[0])
        outs = [np.empty((0, TS_SIZE), np.uint8)] * C
        if not sum(counts):
            return outs
        # One batched RS decode for the whole fleet's packets.
        msgs, failed, bits = rs.decode(
            np.concatenate([r for r in rspkts if len(r)], axis=0))
        msgs = msgs.copy()
        msgs[failed, 0] ^= prbs.MPEG_SYNC_CORRUPTED
        o = 0
        for c in range(C):
            k = counts[c]
            if not k:
                continue
            self.vbitcount[c] += k * RS_SIZE * 8
            self.verrcount[c] += int(bits[o:o + k].sum())
            out, good, self.derand_pos[c] = prbs.derandomize_np(
                msgs[o:o + k], self.derand_pos[c])
            outs[c] = out[good]
            o += k
        return outs

    @property
    def locks(self):
        return [m.synchronized for m in self.mpeg]

    # -- checkpoint/resume (same contract as NativeByteBackend) ----------

    _MPEG_FIELDS = ("polarity", "bitphase", "synchronized",
                    "next_sync_count", "resync_phase", "phase8",
                    "lock_timeleft", "locktime", "locktime_count")

    def save_blob(self) -> bytes:
        return pickle.dumps({
            "mpeg": [{k: getattr(m, k) for k in self._MPEG_FIELDS}
                     for m in self.mpeg],
            "byte_backlog": self.byte_backlog,
            "mpegbyte_backlog": self.mpegbyte_backlog,
            "derand_pos": self.derand_pos,
            "vbitcount": self.vbitcount,
            "verrcount": self.verrcount,
        })

    def restore_blob(self, blob: bytes):
        d = pickle.loads(blob)
        for m, st in zip(self.mpeg, d["mpeg"]):
            for k, v in st.items():
                setattr(m, k, v)
        self.byte_backlog = d["byte_backlog"]
        self.mpegbyte_backlog = d["mpegbyte_backlog"]
        self.derand_pos = d["derand_pos"]
        self.vbitcount = d["vbitcount"]
        self.verrcount = d["verrcount"]


def make_byte_backend(nchan: int, fastlock: bool, on_next_sync=None,
                      native=None):
    """The fleet's byte backend: `native=False` selects the Python
    `_ByteBackend`; `native=None` or True the C++ NativeByteBackend,
    which raises if it does not build. The JAX factory's quiet fallback
    from a failed C++ build to Python is not carried over."""
    if native is False:
        return _ByteBackend(nchan, fastlock, on_next_sync)
    return NativeByteBackend(nchan, fastlock, on_next_sync)


class MultiDvbsReceiver:
    """N-channel receiver: one batched device demod + device decode
    (soft Viterbi, or hard decisions with viterbi=False), and the host
    byte backend (C++, or NumPy with native=False). Entry points run on
    `device` (default CUDA; CUDA without a GPU raises)."""

    def __init__(self, cfg: RxConfig, nchan: int, use_pallas=None,
                 chunk_samples: int | None = None, native=None,
                 segments: int = 1, seg_warmup: int = 2048,
                 seg_holdoff: int = 8, device=None):
        _check_config(cfg, segments, seg_warmup)
        self.device = _dev.resolve_device(device)
        self.cfg = cfg
        self.nchan = nchan
        # The time-segmented demod (_demod_segmented): each chunk as
        # `segments` lane-parallel segments, `seg_warmup` samples of
        # precursor per segment. The first `seg_holdoff` chunks run
        # sequentially, so the loops lock before segmentation engages.
        self.segments = segments
        self.seg_warmup = seg_warmup
        self.seg_holdoff = seg_holdoff
        self._chunk_count = 0
        self._seg_state = None     # per-segment persisted demod state
        self._seg_nseg = 0         # the segment length it was built for
        cstln = make_dvbs2_constellation(cfg.constellation, cfg.rate)
        self.cstln = cstln
        # The demod's route, as the JAX fleet picks it on an accelerator:
        # computed decisions on the demod kernel (sampler="rrc": the
        # matched filter at input rate, then the linear sampler;
        # "linear": the demod alone); exact decisions (exact_lut=True),
        # sampler="nearest" or use_pallas=False on the scan demod, with
        # "rrc" the polyphase fir_sampler at Fs inside it.
        exact = bool(cfg.exact_lut)
        sampler = cfg.sampler
        rrc_coeffs, rrc_steps = (), 1
        self.mf_taps = None
        if sampler == "rrc":
            if exact:
                rrc_coeffs, rrc_steps = rrc_sampler(cfg.Fs, cfg)
            else:
                self.mf_taps = mf_prefilter.make_mf_taps(
                    cfg.Fs, cfg.Fm, cfg.rolloff, cfg.rrc_rej)
                sampler = "linear"
        # Built as the JAX fleet builds it: the fleet never sets
        # allow_drift, so freqw is always clamped to the frequency limits
        # (leansdr_tpu/pipelines/multi_rx.py:717-726, ROADMAP queue 3),
        # and the PLL's gain is cut for the soft path only.
        self.params = receiver.ReceiverParams(
            omega=cfg.Fs / cfg.Fm,
            sampler=sampler,
            nsymbols=cstln.nsymbols,
            freq0=cfg.Ftune / cfg.Fs,
            exact_lut=exact,
            rrc_coeffs=rrc_coeffs,
            rrc_steps=rrc_steps,
            pll_adjustment=1.0 / 6 if cfg.viterbi else 1.0,
        )
        if use_pallas is None:
            use_pallas = sampler == "linear" and not exact
        self.use_pallas = bool(use_pallas) and sampler == "linear"
        state = receiver.init_state(self.params, nchan, self.device)
        if self.use_pallas:
            self._sym_consts = rk.sym_constants(cstln)
            self._planes = rk.pack_state(state)
            self.tables = self.state = None
        else:
            self._sym_consts = self._planes = None
            self.tables = receiver.make_tables(cstln, self.device)
            self.state = state
        self.rate = fleet_rate(cfg.rate)
        self.omega = cfg.Fs / cfg.Fm
        nominal = chunk_samples or (1 << 16)
        on_next = None
        if cfg.viterbi:
            self.deconv = MultiViterbiSync(cstln, self.rate, nchan, nominal,
                                           self.omega, fastlock=cfg.fastlock,
                                           device=self.device)
        else:
            self.deconv = DeviceDeconvolver(self.rate, nchan, nominal,
                                            self.omega, fastlock=cfg.fastlock,
                                            device=self.device)
            if not cfg.fastlock:
                on_next = self.deconv.next_sync
        self.backend = make_byte_backend(nchan, cfg.fastlock, on_next,
                                         native)
        # The framer's resyncs feed the next dispatch's decode: submit()
        # then finishes each chunk's backend before the next dispatch, so
        # it decodes what process() decodes.
        self._sync_feedback = on_next is not None
        self.sample_backlog = np.empty((nchan, 0, 2), np.float32)
        self._pool = None
        self._fetch_pool = None
        self._backend_pool = None
        self._jobs = None
        # Fleet preprocessing (leandvb.cc:277-399), as the JAX fleet
        # builds it: batched device FFTs over all channels, the host FSMs
        # at block rate; CNR and spectrum at ~1 Hz.
        dev = self.device
        self.notch = (bd.BatchedAutoNotch(nchan, cfg.anf, device=dev)
                      if cfg.anf else None)
        every = max(int(cfg.Fs), 1)
        self.cnr_est = (bd.BatchedCnrFft(nchan, cfg.Fm / cfg.Fs,
                                         decimation=every, device=dev)
                        if cfg.cnr else None)
        self.spectrum = (bd.BatchedSpectrum(nchan, decimation=every,
                                            device=dev)
                         if cfg.want_spectrum else None)
        self.cnr = []                  # [C] vectors (dB), ~1 Hz
        self.spectrum_lines = []       # [C, 1024] dB lines
        self._inputs = 0               # submit()/process() calls so far
        self._locks = [False] * nchan  # MPEG lock at the last collect()

    @property
    def dem_state(self):
        """The demod's state: [19, C] planes (kernel) or the scan dict."""
        return self._planes if self.use_pallas else self.state

    @dem_state.setter
    def dem_state(self, st):
        if self.use_pallas:
            self._planes = st
        else:
            self.state = st

    @property
    def readahead(self) -> int:
        """Samples past each chunk the chain reads (sampler lookahead +
        matched-filter overlap)."""
        if self.mf_taps is None:
            return self.params.readahead
        return self.params.readahead + len(self.mf_taps) - 1

    # -- streaming API ----------------------------------------------------

    def process(self, iq):
        """[C, n, 2] float32 IQ -> list of [k_c, 188] TS packet arrays.

        `iq` may be a tensor on the receiver's CUDA device whose length is
        readahead + a multiple of CHUNK (with float_scale already
        applied): it is then consumed directly with no host round trip.
        """
        with self._begin():
            pend = self.dispatch(iq)
            if pend is None:
                return [np.empty((0, TS_SIZE), np.uint8)] * self.nchan
            return self.collect(pend)

    def _begin(self) -> trace.Input:
        """The tracing decision for the next input (trace.begin)."""
        inp = trace.begin(self._inputs)
        self._inputs += 1
        return inp

    def dispatch(self, iq):
        """Enqueue the device work of one chunk; returns a pending handle
        or None if not enough samples are buffered."""
        with trace.span("fleet.dispatch"):
            ra = self.readahead
            preproc = (self.notch is not None or self.cnr_est is not None
                       or self.spectrum is not None)
            if (isinstance(iq, torch.Tensor) and iq.device == self.device
                    and self.device.type == "cuda" and not preproc
                    and self.sample_backlog.shape[1] == 0
                    and (iq.shape[1] - ra) % (receiver.CHUNK
                                              * self.segments) == 0):
                # Device-resident fast path (only without preprocessing, which
                # it must not skip).
                x = iq
                n = iq.shape[1] - ra
            else:
                with trace.span("fleet.ingest"):
                    x = self._ingest(iq, ra)
                if x is None:
                    return None
                n = x.shape[1] - ra

            # The decode schedule comes from host fill bookkeeping; appends
            # larger than the ring's sizing split along time with decodes
            # drained between slices.
            with trace.span("fleet.plan"):
                self.deconv.apply_pending_transition()
                plan_dec = self.deconv.plan_dec
                step = self.deconv.plan.nsamp
                schedule = []
                for o in range(0, n, step):
                    m = min(step, n - o)
                    self.deconv.note_production(
                        max(0, int(m / self.omega) - 8))
                    schedule.append(self.deconv.schedule_decode())
            # The hard decoder always runs every hypothesis: ACQUIRE.
            trace.count("fleet.decodes.track" if getattr(self.deconv, "track",
                                                         False)
                        else "fleet.decodes.acquire", sum(schedule))
            trace.count("fleet.chunks")
            S = self.segments if self._chunk_count >= self.seg_holdoff else 1
            if S > 1 and (self._seg_state is None or self._seg_nseg != n // S):
                # The persisted states assume a constant segment length:
                # (re)build them from the carried chunk-head state.
                self._seg_state = init_seg_state(self.dem_state, self.nchan, S,
                                                 n // S)
                self._seg_nseg = n // S
            (self.dem_state, seg_state, self.deconv.state,
             packed_out) = _fused_chunk(
                self.params, self._sym_consts, self.mf_taps, self.deconv.kind,
                self.deconv.plan, plan_dec, self.deconv.maps, schedule,
                self.dem_state, self._seg_state, self.deconv.state, x,
                segments=S, seg_warmup=self.seg_warmup, tables=self.tables)
            if S > 1:
                self._seg_state = seg_state
            self._chunk_count += 1
            ecols = plan_dec.E + (1 if self.deconv.kind.startswith("viterbi")
                                  else 0)
            shapes = [(plan_dec.nbytes, ecols)] * sum(schedule)
            return packed_out, shapes

    def _ingest(self, iq, ra: int):
        """The host path's ingest: scale, preprocessing, the sample
        backlog and the copy to the device of its whole chunks ([C, n +
        ra, 2]; None until a chunk is buffered)."""
        if isinstance(iq, torch.Tensor):
            iq = iq.cpu().numpy()
        iq = np.asarray(iq, np.float32) * np.float32(self.cfg.float_scale)
        # The notch before the estimators, so a notched birdie does not
        # inflate the CNR (leandvb.cc:277-399).
        if self.notch is not None:
            iq = self.notch.process(iq)
        if self.cnr_est or self.spectrum:
            if self.cnr_est:
                freqw = (self._planes[2] if self.use_pallas
                         else self.state["freqw"])
                self.cnr.extend(self.cnr_est.process(
                    iq, freqw.cpu().numpy() / 65536.0))
            if self.spectrum:
                self.spectrum_lines.extend(self.spectrum.process(iq))
        self.sample_backlog = np.concatenate([self.sample_backlog, iq],
                                             axis=1)
        K = (self.sample_backlog.shape[1] - ra) // receiver.CHUNK
        K -= K % self.segments           # nseg must stay CHUNK-aligned
        if K <= 0:
            return None
        n = K * receiver.CHUNK
        host = np.ascontiguousarray(self.sample_backlog[:, :n + ra])
        trace.count("fleet.h2d_bytes", host.nbytes)
        self.sample_backlog = self.sample_backlog[:, n:]
        return torch.from_numpy(host).to(self.device)

    def prefetch(self, pending):
        """Start the device->host copy of a dispatch()'s packed result on
        a background thread, so it overlaps the host byte backend of the
        previous chunk. Returns a handle accepted by collect()."""
        if pending is None:
            return None
        packed_out, shapes = pending
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(1)
        return self._pool.submit(_to_host, packed_out), shapes

    def collect(self, pending) -> list:
        """Fetch one dispatch()'s results (ONE device->host copy) and run
        the host byte backend."""
        with trace.span("fleet.collect"):
            packed_out, shapes = pending
            with trace.span("fleet.fetch_wait"):
                if hasattr(packed_out, "result"):
                    buf = packed_out.result()        # prefetched
                else:
                    buf = _to_host(packed_out)       # [C, total]
            with trace.span("fleet.unpack"):
                bytes_by_chan = self._unpack(buf, shapes)
            with trace.span("fleet.backend_feed"):
                out = self.backend.feed(bytes_by_chan)
            locks = self.backend.locks
            for was, now in zip(self._locks, locks):
                if was != now:
                    trace.count("fleet.lock_gained" if now
                                else "fleet.lock_lost")
            self._locks = list(locks)
            return out

    def _unpack(self, buf: np.ndarray, shapes) -> list:
        """A fetched buffer -> the new bytes of each channel (the
        decoder's observations and fill fed back on the way)."""
        per_chan = [[] for _ in range(self.nchan)]
        observe = getattr(self.deconv, "observe", None)
        o = 0
        for nb, ne in shapes:
            by = buf[:, o:o + nb]
            o += nb
            errs = np.ascontiguousarray(buf[:, o:o + ne * 4]).view("<i4")
            o += ne * 4
            under = buf[:, o]
            o += 1
            if observe is not None:
                observe(errs, under.astype(bool))
            for c in range(self.nchan):
                if not under[c]:
                    per_chan[c].append(by[c])
        fill = buf[:, o:o + 4].copy().view(np.int32)[:, 0]
        self.deconv.sync_fill(fill)
        return [np.concatenate(p) if p else np.empty(0, np.uint8)
                for p in per_chan]

    # -- software-pipelined streaming --------------------------------------
    #
    # Three overlapped stages, one chunk deep each:
    #   main thread:    dispatch (asynchronous device enqueue)
    #   fetch thread:   device->host copy of the packed bytes
    #   backend thread: MPEG framing / deinterleave / RS / derandomize
    # Safe because dispatch's schedule uses the conservative
    # note_production watermark; collect()'s sync_fill only raises it.
    # With the framer's resync feedback (hard decisions, no fastlock)
    # the backend of chunk k must have run before chunk k+1's dispatch,
    # as in process(): submit() waits for it, so that configuration
    # gains no overlap and decodes exactly what process() decodes.

    max_inflight = 3

    def submit(self, iq) -> list:
        """Enqueue one chunk; return the TS outputs of any chunks whose
        backend completed (a list of per-channel packet-array lists).
        Blocks only when more than `max_inflight` chunks are in flight."""
        inp = self._begin()
        with inp, trace.span("fleet.submit"):
            if self._jobs is None:
                from collections import deque
                from concurrent.futures import ThreadPoolExecutor
                self._fetch_pool = ThreadPoolExecutor(1)
                self._backend_pool = ThreadPoolExecutor(1)
                self._jobs = deque()
            trace.count("fleet.submits")
            done = []
            if self._sync_feedback and self._jobs:
                with trace.span("fleet.wait"):
                    done += [j.result() for j in self._jobs]
                    self._jobs.clear()
            pend = self.dispatch(iq)
            if pend is not None:
                packed_out, shapes = pend
                fut = self._fetch_pool.submit(_fetch_job, inp, packed_out)
                self._jobs.append(self._backend_pool.submit(
                    self._collect_job, inp, trace.stamp(), fut, shapes))
            trace.count("fleet.inflight", len(self._jobs))
            if len(self._jobs) > self.max_inflight:
                with trace.span("fleet.wait"):
                    while len(self._jobs) > self.max_inflight:
                        done.append(self._jobs.popleft().result())
            while self._jobs and self._jobs[0].done():
                done.append(self._jobs.popleft().result())
            return done

    def _collect_job(self, inp: trace.Input, queued: int, fut, shapes):
        """collect() on the back-end thread, traced as its input was."""
        with inp:
            trace.since("fleet.backend_queue", queued)
            return self.collect((fut, shapes))

    def flush(self) -> list:
        """Wait for all in-flight chunks; return their TS outputs."""
        if not self._jobs:
            return []
        done = [j.result() for j in self._jobs]
        self._jobs.clear()
        return done

    def close(self):
        """Stop the worker threads (after flush())."""
        for pool in (self._pool, self._fetch_pool, self._backend_pool):
            if pool is not None:
                pool.shutdown(wait=True)
        self._pool = self._fetch_pool = self._backend_pool = None
        self._jobs = None

    # -- checkpoint/resume --------------------------------------------------

    # The decoder's host fields: MultiViterbiSync's TRACK policy, or
    # DeviceDeconvolver's fill estimate and queued resyncs.
    _DECONV_HOST_FIELDS = ("_est_fill", "track", "_want_track", "_stable",
                           "_last_cur", "_entry_d", "track_after",
                           "_track_decodes", "_resyncs")

    def save_state(self) -> bytes:
        """Serialize every mutable piece of the receiver: demod state
        (and the segmented demod's per-segment states), the symbol ring +
        trellis or hard-decision state, the byte backend's FSMs and the
        sample backlog, as NumPy arrays in a pickle."""
        seg = self._seg_state
        return pickle.dumps({
            "format": CHECKPOINT_FORMAT,
            "use_pallas": self.use_pallas,
            "dev": state_to_numpy(self.dem_state),
            "seg_state": None if seg is None else state_to_numpy(seg),
            "seg_nseg": self._seg_nseg,
            "deconv_state": {k: v.cpu().numpy()
                             for k, v in self.deconv.state.items()},
            "deconv_host": {k: getattr(self.deconv, k)
                            for k in self._DECONV_HOST_FIELDS
                            if hasattr(self.deconv, k)},
            "backend": self.backend.save_blob(),
            "backend_native": type(self.backend).__name__,
            "sample_backlog": self.sample_backlog,
            "chunk_count": self._chunk_count,
        })

    def load_state(self, blob: bytes) -> None:
        """Restore a save_state() blob (or one converted from the JAX
        receiver by convert.from_jax_checkpoint)."""
        d = pickle.loads(blob)
        if d.get("format") != CHECKPOINT_FORMAT:
            raise ValueError("not a leansdr_tpu_torch receiver checkpoint "
                             "(convert a JAX one with "
                             "convert.from_jax_checkpoint)")
        dev = self.device
        # Planes or a scan dict, converted to this receiver's route.
        st = state_from_numpy(d["dev"], self.use_pallas, self.params, dev)
        if nlanes(st) != self.nchan:
            raise ValueError(f"checkpoint demod state of {nlanes(st)} "
                             f"channels != {self.nchan}")
        self.dem_state = st
        seg = d.get("seg_state")
        if seg is not None:
            seg = state_from_numpy(seg, self.use_pallas, self.params, dev)
            if nlanes(seg) != self.segments * self.nchan:
                raise ValueError(f"checkpoint segment states of "
                                 f"{nlanes(seg)} lanes != "
                                 f"{self.segments * self.nchan} (another "
                                 "segments=?)")
        self._seg_state = seg
        self._seg_nseg = d.get("seg_nseg", 0)
        if set(d["deconv_state"]) != set(self.deconv.state):
            raise ValueError(
                f"checkpoint decoder state {sorted(d['deconv_state'])} != "
                f"{sorted(self.deconv.state)} (another code rate or "
                "viterbi setting?)")
        self.deconv.state = {k: torch.from_numpy(np.array(v)).to(dev)
                             for k, v in d["deconv_state"].items()}
        for k, v in d["deconv_host"].items():
            setattr(self.deconv, k, v)
        if d["backend_native"] != type(self.backend).__name__:
            raise ValueError(f"checkpoint byte backend {d['backend_native']}"
                             f" != {type(self.backend).__name__}")
        self.backend.restore_blob(d["backend"])
        self._locks = list(self.backend.locks)
        self.sample_backlog = d["sample_backlog"]
        self._chunk_count = d["chunk_count"]

    def metrics(self):
        """Per-channel measurement snapshot (one small device->host copy;
        call at info rate, ~1 Hz): dict of [C] arrays freq (fraction of
        Fs), ss, mer_db (sdr.h:852-889 estimator state)."""
        if self.use_pallas:
            p = self._planes.cpu().numpy()
            freqw, est_insp, est_sp, est_ep = p[2], p[4], p[5], p[6]
        else:
            freqw, est_insp, est_sp, est_ep = (
                self.state[k].cpu().numpy()
                for k in ("freqw", "est_insp", "est_sp", "est_ep"))
        mer = np.where(est_ep > 0,
                       10 * np.log10(np.maximum(est_sp, 1e-30)
                                     / np.maximum(est_ep, 1e-30)), 0.0)
        return {"freq": freqw / 65536.0, "ss": np.sqrt(est_insp),
                "mer_db": mer}

    @property
    def locks(self):
        return self.backend.locks

    @property
    def vbitcount(self):
        return self.backend.vbitcount

    @property
    def verrcount(self):
        return self.backend.verrcount


def _to_host(t: torch.Tensor) -> np.ndarray:
    trace.count("fleet.d2h_bytes", t.numel() * t.element_size())
    return t.cpu().numpy()


def _fetch_job(inp: trace.Input, t: torch.Tensor) -> np.ndarray:
    """_to_host on the fetch thread, traced as its input was (the wait for
    the chunk's device work included)."""
    with inp, trace.span("fleet.fetch"):
        return _to_host(t)
