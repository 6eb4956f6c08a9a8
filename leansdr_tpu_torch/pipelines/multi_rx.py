"""Multi-carrier DVB-S receiver: many independent carriers demodulated and
Viterbi-decoded in one device batch (the counterpart of
leansdr_tpu/pipelines/multi_rx.py, sequential demod, `segments=1`).

Chain per chunk, all on the device until one packed fetch:

  matched filter (dsp/mf_prefilter.py)
    -> demod kernel (csrc/demod.cu: PLL + M&M timing + soft demap)
    -> symbol ring append (fec/deconv_device.py: cumsum + scatter)
    -> soft Viterbi over the sync replicas with election:
       rate 1/2, 4 replicas: csrc/acs.cu inside
         fec/viterbi_device.viterbi_decode;
       rates 2/3 (run as "4/6"), 3/4, 5/6, 7/8, 4 x nshifts replicas:
         punctured block inputs -> csrc/acs_banked.cu inside
         fec/viterbi_device.viterbi_decode_banked
    -> ONE packed u8 buffer per chunk (bytes | discriminants | underflow
       per decode, then the ring fill)
  host: the C++ byte backend (native/): MPEG framing, deinterleave,
        RS(204,188), derandomize -> TS packets per channel.

The decode schedule is decided on the host from conservative fill
bookkeeping, so the device work of a chunk needs no host sync.
"""

import pickle

import numpy as np
import torch

from .. import device as _dev
from ..dsp import mf_prefilter, receiver
from ..dsp import receiver_kernel as rk
from ..dsp.cstln import Predef, make_dvbs2_constellation
from ..fec.deconv_device import deconv_append
from ..fec.viterbi_banked import fleet_rate
from ..fec.viterbi_device import MultiViterbiSync, decoder
from ..native import NativeByteBackend
from .dvbs_rx import RxConfig, TS_SIZE

CHECKPOINT_FORMAT = "leansdr_tpu_torch.multi_rx/1"
RATES = ("1/2", "2/3", "3/4", "5/6", "7/8")     # the DVB-S code rates


def _pack_fetch(fill: torch.Tensor, flat: list) -> torch.Tensor:
    """Concatenate the chunk's decode results + the fill watermark into
    ONE u8 [C, total] tensor, so the host pays a single transfer.

    flat: triples (bytes [C,NB] u8, errs [C,E] i32, under [C] bool).
    Layout per channel row: nd x [NB bytes | E*4 errs | 1 under] | 4 fill
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


def _fused_chunk(params, sym_consts, mf_taps, kind, plan, plan_dec, maps,
                 schedule, planes, dstate, x):
    """One chunk of device work: matched filter -> demod kernel ->
    sym/valid/cost extraction -> ring append(s) -> `schedule` decodes
    (the decoder of `kind`) -> the packed fetch buffer. Plain eager
    PyTorch around the kernels. Returns (planes, dstate, packed_out)."""
    decode = decoder(kind)
    x = mf_prefilter.mf_prefilter(mf_taps, planes[2], x)
    planes, packed = rk.demod(params, sym_consts, planes, x)
    sym, valid, cost = _extract_sym_valid(packed)
    n = sym.shape[0]
    step = plan.nsamp
    flat = []
    for i, o in enumerate(range(0, n, step)):
        m = min(step, n - o)
        dstate = deconv_append(plan, dstate, sym[o:o + m], valid[o:o + m],
                               cost[o:o + m])
        for _ in range(schedule[i]):
            dstate, by, errs, under = decode(plan_dec, dstate, maps)
            flat += [by, errs, under]
    return planes, dstate, _pack_fetch(dstate["fill"], flat)


def _unsupported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1 item {item}); the "
        f"port runs QPSK at rates {', '.join(RATES)} with viterbi=True, "
        "exact_lut=False, sampler='rrc', segments=1")


def _check_config(cfg: RxConfig, use_pallas, native, segments):
    if cfg.constellation != Predef.QPSK or cfg.rate not in RATES:
        _unsupported(f"{Predef(cfg.constellation).name} rate {cfg.rate}",
                     "20")
    if not cfg.viterbi:
        _unsupported("the hard-decision fleet path (viterbi=False)", "7")
    if cfg.exact_lut is None:
        raise ValueError("RxConfig.exact_lut must be given explicitly "
                         "(False: the computed demod path)")
    if cfg.exact_lut:
        _unsupported("the exact-LUT scan demod (exact_lut=True)", "10")
    if cfg.sampler != "rrc":
        _unsupported(f"sampler={cfg.sampler!r}", "10")
    if segments != 1:
        _unsupported("the segmented demod (segments > 1)", "8")
    if cfg.anf or cfg.cnr or cfg.want_spectrum:
        _unsupported("fleet preprocessing (anf, cnr, spectrum)", "13")
    if use_pallas is False:
        _unsupported("a demod without the kernel (use_pallas=False)", "10")
    if native is False:
        _unsupported("the Python byte backend (native=False)", "7")


class MultiDvbsReceiver:
    """N-channel receiver: one batched device demod + Viterbi, and the
    C++ host byte backend. Entry points run on `device` (default CUDA;
    CUDA without a GPU raises)."""

    def __init__(self, cfg: RxConfig, nchan: int, use_pallas=None,
                 chunk_samples: int | None = None, native=None,
                 segments: int = 1, seg_warmup: int = 2048,
                 seg_holdoff: int = 8, device=None):
        self.device = _dev.resolve_device(device)
        _check_config(cfg, use_pallas, native, segments)
        self.cfg = cfg
        self.nchan = nchan
        self._chunk_count = 0
        cstln = make_dvbs2_constellation(cfg.constellation, cfg.rate)
        # Matched filter at input rate, then the linear-sampler demod.
        self.mf_taps = mf_prefilter.make_mf_taps(cfg.Fs, cfg.Fm, cfg.rolloff,
                                                 cfg.rrc_rej)
        # Built as the JAX fleet builds it: the fleet never sets
        # allow_drift, so freqw is always clamped to the frequency limits
        # (leansdr_tpu/pipelines/multi_rx.py:717-726, ROADMAP queue 3).
        self.params = receiver.ReceiverParams(
            omega=cfg.Fs / cfg.Fm,
            sampler="linear",
            nsymbols=cstln.nsymbols,
            freq0=cfg.Ftune / cfg.Fs,
            exact_lut=False,
            pll_adjustment=1.0 / 6,
        )
        self._sym_consts = rk.sym_constants(cstln)
        self._planes = rk.pack_state(
            receiver.init_state(self.params, nchan, self.device))
        self.rate = fleet_rate(cfg.rate)
        self.omega = cfg.Fs / cfg.Fm
        nominal = chunk_samples or (1 << 16)
        self.deconv = MultiViterbiSync(cstln, self.rate, nchan, nominal,
                                       self.omega, fastlock=cfg.fastlock,
                                       device=self.device)
        self.backend = NativeByteBackend(nchan, cfg.fastlock)
        self.sample_backlog = np.empty((nchan, 0, 2), np.float32)
        self._pool = None
        self._fetch_pool = None
        self._backend_pool = None
        self._jobs = None

    @property
    def readahead(self) -> int:
        """Samples past each chunk the chain reads (sampler lookahead +
        matched-filter overlap)."""
        return self.params.readahead + len(self.mf_taps) - 1

    # -- streaming API ----------------------------------------------------

    def process(self, iq):
        """[C, n, 2] float32 IQ -> list of [k_c, 188] TS packet arrays.

        `iq` may be a tensor on the receiver's CUDA device whose length is
        readahead + a multiple of CHUNK (with float_scale already
        applied): it is then consumed directly with no host round trip.
        """
        pend = self.dispatch(iq)
        if pend is None:
            return [np.empty((0, TS_SIZE), np.uint8)] * self.nchan
        return self.collect(pend)

    def dispatch(self, iq):
        """Enqueue the device work of one chunk; returns a pending handle
        or None if not enough samples are buffered."""
        ra = self.readahead
        if (isinstance(iq, torch.Tensor) and iq.device == self.device
                and self.device.type == "cuda"
                and self.sample_backlog.shape[1] == 0
                and (iq.shape[1] - ra) % receiver.CHUNK == 0):
            # Device-resident fast path.
            x = iq
            n = iq.shape[1] - ra
        else:
            if isinstance(iq, torch.Tensor):
                iq = iq.cpu().numpy()
            iq = np.asarray(iq, np.float32) * np.float32(
                self.cfg.float_scale)
            self.sample_backlog = np.concatenate(
                [self.sample_backlog, iq], axis=1)
            K = (self.sample_backlog.shape[1] - ra) // receiver.CHUNK
            if K <= 0:
                return None
            n = K * receiver.CHUNK
            x = torch.from_numpy(np.ascontiguousarray(
                self.sample_backlog[:, :n + ra])).to(self.device)
            self.sample_backlog = self.sample_backlog[:, n:]

        # The decode schedule comes from host fill bookkeeping; appends
        # larger than the ring's sizing split along time with decodes
        # drained between slices.
        self.deconv.apply_pending_transition()
        plan_dec = self.deconv.plan_dec
        step = self.deconv.plan.nsamp
        schedule = []
        for o in range(0, n, step):
            m = min(step, n - o)
            self.deconv.note_production(max(0, int(m / self.omega) - 8))
            schedule.append(self.deconv.schedule_decode())
        self._planes, self.deconv.state, packed_out = _fused_chunk(
            self.params, self._sym_consts, self.mf_taps, self.deconv.kind,
            self.deconv.plan, plan_dec, self.deconv.maps, schedule,
            self._planes,
            self.deconv.state, x)
        self._chunk_count += 1
        shapes = [(plan_dec.nbytes, plan_dec.E + 1)] * sum(schedule)
        return packed_out, shapes

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
        packed_out, shapes = pending
        if hasattr(packed_out, "result"):
            buf = packed_out.result()                # prefetched
        else:
            buf = _to_host(packed_out)               # [C, total]
        per_chan = [[] for _ in range(self.nchan)]
        o = 0
        for nb, ne in shapes:
            by = buf[:, o:o + nb]
            o += nb
            errs = np.ascontiguousarray(buf[:, o:o + ne * 4]).view("<i4")
            o += ne * 4
            under = buf[:, o]
            o += 1
            self.deconv.observe(errs, under.astype(bool))
            for c in range(self.nchan):
                if not under[c]:
                    per_chan[c].append(by[c])
        fill = buf[:, o:o + 4].copy().view(np.int32)[:, 0]
        self.deconv.sync_fill(fill)
        bytes_by_chan = [
            np.concatenate(p) if p else np.empty(0, np.uint8)
            for p in per_chan]
        return self.backend.feed(bytes_by_chan)

    # -- software-pipelined streaming --------------------------------------
    #
    # Three overlapped stages, one chunk deep each:
    #   main thread:    dispatch (asynchronous device enqueue)
    #   fetch thread:   device->host copy of the packed bytes
    #   backend thread: MPEG framing / deinterleave / RS / derandomize
    # Safe because dispatch's schedule uses the conservative
    # note_production watermark; collect()'s sync_fill only raises it.

    max_inflight = 3

    def submit(self, iq) -> list:
        """Enqueue one chunk; return the TS outputs of any chunks whose
        backend completed (a list of per-channel packet-array lists).
        Blocks only when more than `max_inflight` chunks are in flight."""
        if self._jobs is None:
            from collections import deque
            from concurrent.futures import ThreadPoolExecutor
            self._fetch_pool = ThreadPoolExecutor(1)
            self._backend_pool = ThreadPoolExecutor(1)
            self._jobs = deque()
        pend = self.dispatch(iq)
        if pend is not None:
            packed_out, shapes = pend
            fut = self._fetch_pool.submit(_to_host, packed_out)
            self._jobs.append(
                self._backend_pool.submit(self.collect, (fut, shapes)))
        done = []
        while self._jobs and (self._jobs[0].done()
                              or len(self._jobs) > self.max_inflight):
            done.append(self._jobs.popleft().result())
        return done

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

    _DECONV_HOST_FIELDS = ("_est_fill", "track", "_want_track", "_stable",
                           "_last_cur", "_entry_d", "track_after",
                           "_track_decodes")

    def save_state(self) -> bytes:
        """Serialize every mutable piece of the receiver: demod state,
        the symbol ring + trellis state, the byte backend (the C++ FSMs)
        and the sample backlog, as NumPy arrays in a pickle."""
        return pickle.dumps({
            "format": CHECKPOINT_FORMAT,
            "dev": self._planes.cpu().numpy(),
            "deconv_state": {k: v.cpu().numpy()
                             for k, v in self.deconv.state.items()},
            "deconv_host": {k: getattr(self.deconv, k)
                            for k in self._DECONV_HOST_FIELDS},
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
        planes = torch.from_numpy(np.asarray(d["dev"], np.float32))
        if tuple(planes.shape) != (rk.NSTATE, self.nchan):
            raise ValueError(f"checkpoint demod state {tuple(planes.shape)}"
                             f" != {(rk.NSTATE, self.nchan)}")
        self._planes = planes.to(dev).contiguous()
        if set(d["deconv_state"]) != set(self.deconv.state):
            raise ValueError(
                f"checkpoint trellis state {sorted(d['deconv_state'])} != "
                f"{sorted(self.deconv.state)} (another code rate?)")
        self.deconv.state = {k: torch.from_numpy(np.array(v)).to(dev)
                             for k, v in d["deconv_state"].items()}
        for k, v in d["deconv_host"].items():
            setattr(self.deconv, k, v)
        if d["backend_native"] != type(self.backend).__name__:
            raise ValueError(f"checkpoint byte backend {d['backend_native']}"
                             f" != {type(self.backend).__name__}")
        self.backend.restore_blob(d["backend"])
        self.sample_backlog = d["sample_backlog"]
        self._chunk_count = d["chunk_count"]

    def metrics(self):
        """Per-channel measurement snapshot (one small device->host copy;
        call at info rate, ~1 Hz): dict of [C] arrays freq (fraction of
        Fs), ss, mer_db (sdr.h:852-889 estimator state)."""
        p = self._planes.cpu().numpy()
        freqw, est_insp, est_sp, est_ep = p[2], p[4], p[5], p[6]
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
    return t.cpu().numpy()
