"""The single-carrier DVB-S receiver (the leandvb equivalent, reference
leandvb.cc:157-724), and RxConfig: the counterpart of
leansdr_tpu/pipelines/dvbs_rx.py.

Chain per call of `DvbsReceiver.process`:

  IQ [n, 2] float32 -> float scale
    -> preprocessing (host unless noted): --awgn (the drand48 Gaussian
       noise of pipelines/chansim.py, continued across calls),
       auto-notch (dsp/blocks_device:
       cuFFT detection, device trackers), derotation (dsp/blocks.Rotator),
       --cnr and --fd-spectrum (dsp/blocks_device CnrFft1 / Spectrum1:
       cuFFT of one block per Fs samples, the EMA and band model on the
       host; `meas["cnr"]`, `spectrum_lines`), --resample
       (dsp/fir_kernel.FirFilterDevice on csrc/fir.cu) or --decim
    -> the demod on [1, n + readahead, 2], one of two routes, as the JAX
       receiver builds them:
         the demod kernel (csrc/demod.cu, `use_pallas`): computed
           decisions, linear sampler, behind the matched filter
           (dsp/mf_prefilter.py) with --sampler rrc;
         the scan demod (dsp/receiver.run_chunks on csrc/scan_demod.cu):
           --exact-lut (the trig16 table and the 256x256 LUT; with
           --sampler rrc the polyphase fir_sampler in the loop),
           --hard-metric (the LUT's cost hardened to +-1), --sampler
           nearest, or use_pallas=False (computed decisions);
       or with `segments=S` (--segments) the fleet's time-segmented
       demod (pipelines/multi_rx._demod_segmented) on either route: the
       call's samples as S lane-parallel segments, two launches
    -> hard symbols: algebraic deconvolution (fec/deconv.py, host; its
       sync maps are QPSK's, so a constellation with more than 4
       symbols raises IndexError on its first symbol past 3, as the JAX
       receiver does), or soft symbols: ViterbiSyncDevice (fec/viterbi.py)
       on the fleet's ACS kernels (csrc/acs.cu at 1/2, csrc/acs_banked.cu
       otherwise), at every constellation and rate
    -> MPEG sync (proto/framing.py) -> deinterleave -> RS(204,188)
       -> derandomize (fec/, host NumPy) -> TS packets;
       or with --hdlc the ETR192 descrambler and the HDLC deframer
       (proto/hdlc.py, host) -> frames in `hdlc_frames` (with
       --packetized each behind its 16-bit length).

--hs (u8 input only) takes the integer fast-QPSK receiver instead
(dsp/receiver_hs.run_chunks_hs on csrc/hs_demod.cu) and its own
deconvolver (`_DeconvolSyncHS`, host NumPy).

Measurements (FREQ/SS/MER): on the kernel route, snapshots of the state
planes at the meas_decimation cadence; on the scan route, the scan's own
per-chunk measurements (`_collect_meas`). They also feed the resampler's
carrier tracking (freq_tap), as in the JAX receiver.

Unlike the fleet, this receiver honours `allow_drift` (--drift), as the
JAX single-carrier receiver does (leansdr_tpu/pipelines/dvbs_rx.py:302).
"""

import copy
import os
import pickle
import sys
from dataclasses import dataclass

import numpy as np
import torch

from .. import device as _dev
from ..core.generic import RateEstimator
from ..dsp import blocks, filtergen, mf_prefilter, receiver, receiver_hs
from ..dsp import receiver_kernel as rk
from ..dsp.blocks_device import AutoNotch1, CnrFft1, Spectrum1
from ..dsp.cstln import Predef, make_dvbs2_constellation
from ..dsp.fir_kernel import FirFilterDevice
from ..fec import deconv, interleave, prbs, rs
from ..fec.viterbi import ViterbiSyncDevice, make_sync_maps
from ..fec.viterbi_banked import fleet_rate, viterbi_rate
from ..proto.framing import MpegSync
from ..proto.hdlc import HdlcSync, etr192_descramble
from ..util import trace
from . import chansim

TS_SIZE = 188
RS_SIZE = 204
CHECKPOINT_FORMAT = "leansdr_tpu_torch.dvbs_rx/1"


@dataclass
class RxConfig:
    Fs: float = 2.4e6
    Fm: float = 2e6
    constellation: Predef = Predef.QPSK
    rate: str = "1/2"
    sampler: str = "linear"
    float_scale: float = 1.0
    fastlock: bool = False
    viterbi: bool = False
    hard_metric: bool = False
    allow_drift: bool = False
    Ftune: float = 0.0
    Finfo: float = 5.0
    rrc_rej: float = 30.0
    rrc_steps: int = 0
    rolloff: float = 0.35
    # True: the bit-exact trig16/256x256-LUT decision path (the scan
    # demod); False: computed decisions (the demod kernel, or the scan
    # demod for --sampler nearest and use_pallas=False). Must be given
    # explicitly (the JAX package resolves None from its backend; the CLI
    # says False unless --exact-lut).
    exact_lut: bool | None = None
    # Preprocessing chain (leandvb.cc:277-399):
    awgn: float = 0.0
    anf: int = 0
    Fderot: float = 0.0
    cnr: bool = False
    want_spectrum: bool = False
    resample: bool = False
    resample_rej: float = 10.0
    decim: int = 0
    hs: bool = False
    want_const: bool = False
    hdlc: bool = False
    packetized: bool = False
    use_pallas: bool | None = None
    debug: bool = False
    fd_pp: int = -1
    segments: int = 1
    seg_warmup: int = 2048
    seg_holdoff: int = 8


def _check_config(cfg: RxConfig):
    """Raise for an invalid setting, before any device is asked for: the
    combinations of constellation and rate the JAX receiver refuses raise
    its errors (make_dvbs2_constellation's and make_sync_maps'
    ValueError; the hard decoder's KeyError at 4/5)."""
    cstln = make_dvbs2_constellation(cfg.constellation, cfg.rate)
    if cfg.viterbi and not cfg.hs:
        make_sync_maps(cstln, viterbi_rate(cfg.rate, cstln.nsymbols))
    elif not cfg.hs:
        deconv.deconv_spec(fleet_rate(cfg.rate))
    if cfg.exact_lut is None:
        raise ValueError("RxConfig.exact_lut must be given explicitly "
                         "(False: computed decisions)")
    if cfg.seg_warmup % receiver.CHUNK:
        raise ValueError(
            f"seg_warmup must be a multiple of {receiver.CHUNK}")
    if cfg.sampler not in ("nearest", "linear", "rrc"):
        raise ValueError(f"sampler={cfg.sampler!r}: nearest, linear or rrc")


def rrc_sampler(Fs: float, cfg: RxConfig) -> tuple:
    """(coefficients, subsampling) of the polyphase fir_sampler at sample
    rate Fs (sdr.h:635-689), as the JAX receivers build it."""
    steps = cfg.rrc_steps or max(1, int(64 * cfg.Fm / Fs))
    Frrc = Fs * steps
    transition = (cfg.Fm / 2) * cfg.rolloff
    order = int(cfg.rrc_rej * Frrc / (22 * transition))
    return (tuple(filtergen.root_raised_cosine(order, cfg.Fm / Frrc,
                                               cfg.rolloff).tolist()),
            steps)


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A demod output to the host (the host waits for the device work
    before it), counted in rx.d2h_bytes."""
    a = t.cpu().numpy()
    trace.count("rx.d2h_bytes", a.nbytes)
    return a


def state_to_numpy(st):
    """A demod state (planes tensor or a dict of tensors) as NumPy."""
    if isinstance(st, dict):
        return {k: v.cpu().numpy() for k, v in st.items()}
    return st.cpu().numpy()


def state_from_numpy(v, use_pallas: bool, params, device):
    """A checkpoint's demod state (planes [19, lanes], or the scan dict
    of [lanes] / [lanes, 3, 2] / [lanes, nc, 2] arrays) as the route
    expects it: planes for the demod kernel, the scan dict otherwise."""
    if use_pallas:
        if isinstance(v, dict):
            return rk.pack_state({k: torch.from_numpy(np.asarray(a))
                                  for k, a in v.items()}).to(device)
        return torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(
            device)
    if not isinstance(v, dict):
        v = {k: t.numpy() for k, t in rk.unpack_state(torch.from_numpy(
            np.ascontiguousarray(v, np.float32))).items()}
    want = receiver.init_state(params, 1, "cpu")
    if set(v) != set(want):
        raise ValueError(f"checkpoint demod state {sorted(v)} != "
                         f"{sorted(want)} (another sampler?)")
    return {k: torch.from_numpy(np.array(a, want[k].numpy().dtype)).to(
        device) for k, a in v.items()}


class _DeconvolSync:
    """The algebraic deconvolver over a symbol stream (deconvol_sync,
    dvb.h:122-476; leansdr_tpu/pipelines/dvbs_rx.py:87-160).

    Keeps a symbol backlog; decodes via the static-window formulation in
    fec/deconv.py. Non-fastlock: single locked sync, rotated by
    next_sync(); fastlock: all 4 hypotheses scored each block, fewest
    deconvolution errors wins, symbol slip when BER > 1/3.
    """

    # The reference's symbol pipebuf holds 4096 symbols (BUF_SYMBOLS,
    # leandvb.cc:190), so fastlock re-elects about every ~4k symbols.
    BLOCK_SYMBOLS = 4096
    STATE = ("locked", "skip", "backlog")

    def __init__(self, rate: str, fastlock: bool, debug: bool = False):
        self.spec = deconv.deconv_spec(rate)
        self.rate = rate
        self.fastlock = fastlock
        self.debug = debug
        self.locked = 0
        self.skip = 0
        self.backlog = np.empty(0, np.uint8)   # hard symbols

    def next_sync(self):
        # dvb.h:185-193
        self.locked += 1
        if self.locked == 4:
            self.locked = 0
            self.skip = 1

    def process(self, symbols: np.ndarray) -> np.ndarray:
        out = [self._process_block(symbols[i:i + self.BLOCK_SYMBOLS])
               for i in range(0, len(symbols), self.BLOCK_SYMBOLS)]
        out = [o for o in out if len(o)]
        return np.concatenate(out) if out else np.empty(0, np.uint8)

    def _process_block(self, symbols: np.ndarray) -> np.ndarray:
        self.backlog = np.concatenate([self.backlog, symbols])
        if self.skip:
            self.backlog = self.backlog[self.skip:]
            self.skip = 0
        spec = self.spec
        nbits = 2 * len(self.backlog)
        if nbits < deconv.TRACEBACK:
            return np.empty(0, np.uint8)
        P = (nbits - deconv.TRACEBACK) // spec.punctweight + 1
        nppb = int(np.lcm(8, spec.punctperiod)) // spec.punctperiod
        P = (P // nppb) * nppb
        nbytes = P * spec.punctperiod // 8
        # The reference's "require enough symbols to discriminate"
        # threshold (dvb.h:424-426).
        if nbytes < 32:
            return np.empty(0, np.uint8)
        if self.fastlock:
            errs = [deconv.deconvolve_errors(self.backlog, self.rate, s)
                    for s in range(4)]
            best = int(np.argmin(errs))
            if best != self.locked:
                if self.debug:
                    # "{a->b}": sync-alignment election (dvb.h:442-447)
                    sys.stderr.write(f"{{{self.locked}->{best}}}\n")
                self.locked = best
            if errs[best] > nbytes * 8 // 3:
                self.skip = 1
        out = deconv.deconvolve_block(self.backlog, self.rate, self.locked)
        out = out[:nbytes]
        # Drop the symbols fully consumed, keeping the window overlap
        # (windows end at TRACEBACK + p*punctweight bits).
        consumed_bits = P * spec.punctweight
        self.backlog = self.backlog[consumed_bits // 2:]
        return out


class _DeconvolSyncHS:
    """The --hs algebraic deconvolver (dvb_deconvol_sync, dvb.h:612-703;
    leansdr_tpu/pipelines/dvbs_rx.py:163-199): QPSK 1/2 polynomials
    0x3ba / 0x38f70 hardcoded, 4 sync LUTs, chunks of 64 bytes (512
    symbols), election every resync_period chunks by estimated error
    bits."""

    CHUNK_BYTES = 64
    STATE = ("locked", "resync_phase", "backlog")

    def __init__(self, fastlock: bool):
        self.maps = deconv.hs_sync_maps()
        self.locked = 0
        self.resync_phase = 0
        self.resync_period = 1 if fastlock else 32
        self.backlog = np.empty(0, np.uint8)

    def process(self, symbols: np.ndarray) -> np.ndarray:
        self.backlog = np.concatenate([self.backlog, symbols])
        out = []
        # 512 symbols per chunk + 32-symbol window warmup overlap
        need = self.CHUNK_BYTES * 8 + deconv.TRACEBACK // 2
        while len(self.backlog) >= need:
            if self.resync_phase == 0:
                errs = [deconv.deconvolve_errors(
                            self.backlog[:need], "1/2", 0, symmap=self.maps[s])
                        for s in range(4)]
                self.locked = int(np.argmin(errs))
            b = deconv.deconvolve_block(
                self.backlog[:need], "1/2", 0,
                symmap=self.maps[self.locked])[:self.CHUNK_BYTES]
            out.append(b)
            self.backlog = self.backlog[self.CHUNK_BYTES * 8:]
            self.resync_phase += 1
            if self.resync_phase >= self.resync_period:
                self.resync_phase = 0
        return np.concatenate(out) if out else np.empty(0, np.uint8)


class TsStages:
    """The TS half of one carrier's host byte chain: MPEG sync ->
    deinterleave -> RS -> derandomize (dvb.h), on the owner's `mpeg`,
    `byte_backlog`, `mpegbyte_backlog` and `derand_pos`. DvbsReceiver and
    the candidate scan's per-candidate chains (multi_rx._ByteChain) share
    it."""

    def _ts_init(self, mpeg: MpegSync):
        self.mpeg = mpeg
        self.byte_backlog = np.empty(0, np.uint8)       # deconv -> mpeg_sync
        self.mpegbyte_backlog = np.empty(0, np.uint8)   # mpeg -> deinterleave
        self.derand_pos = 0

    def _ts_stages(self, bytes_out: np.ndarray) -> tuple:
        """New bytes -> (the TS packets [n, 188] they end, RS's failed
        mask and corrected bits per RS packet decoded; both None when no
        RS packet was complete)."""
        if len(bytes_out):
            self.byte_backlog = np.concatenate([self.byte_backlog, bytes_out])
        pkts, consumed = self.mpeg.process(self.byte_backlog)
        self.byte_backlog = self.byte_backlog[consumed:]
        if len(pkts):
            self.mpegbyte_backlog = np.concatenate(
                [self.mpegbyte_backlog, pkts.reshape(-1)])
        rspkts, self.mpegbyte_backlog = interleave.deinterleave(
            self.mpegbyte_backlog)
        if not len(rspkts):
            return np.empty((0, TS_SIZE), np.uint8), None, None
        msgs, failed, bits = rs.decode(rspkts)
        # Corrupted packets keep flowing with a marked sync byte so the
        # derandomizer keeps phase (dvb.h:1043-1046).
        msgs = msgs.copy()
        msgs[failed, 0] ^= prbs.MPEG_SYNC_CORRUPTED
        out, good, self.derand_pos = prbs.derandomize_np(msgs,
                                                         self.derand_pos)
        return out[good], failed, bits


class DvbsReceiver(TsStages):
    """Single-carrier streaming receiver on the device kernels. Entry
    points run on `device` (default CUDA; CUDA without a GPU raises)."""

    # The streaming fields of the Viterbi decoder a checkpoint carries.
    VITERBI_STATE = ("current", "resync_phase", "sym_backlog",
                     "cost_backlog")

    def __init__(self, cfg: RxConfig, device=None):
        _check_config(cfg)
        self.device = _dev.resolve_device(device)
        self.cfg = cfg
        rate = cfg.rate
        cstln = make_dvbs2_constellation(cfg.constellation, rate)
        if cfg.hard_metric:
            cstln = copy.deepcopy(cstln)
            cstln.harden()
        self.cstln = cstln

        # ---- preprocessing chain (leandvb.cc:277-399) ----
        self.noise_draws = 0          # drand48 draws of --awgn so far
        self.notch = (AutoNotch1(cfg.anf, 0.0, device=self.device)
                      if cfg.anf else None)
        self.derot = (blocks.Rotator(-cfg.Fderot / cfg.Fs)
                      if cfg.Fderot else None)
        # --cnr / --fd-spectrum at ~1 Hz: one block per Fs samples.
        every = max(int(cfg.Fs), 1)
        self.cnr_est = (CnrFft1(cfg.Fm / cfg.Fs, decimation=every,
                                device=self.device) if cfg.cnr else None)
        self.spectrum = (Spectrum1(decimation=every, device=self.device)
                         if cfg.want_spectrum else None)
        decim = 1
        self.resampler = None
        Fs_eff = cfg.Fs
        if cfg.resample:
            # Lowpass + decimate to just above 4 samples/symbol
            # (leandvb.cc:353-384), at the ingest rate on the complex FIR
            # kernel with runtime taps, so a carrier retune never
            # rebuilds anything.
            decim = cfg.decim or max(1, int(cfg.Fs / (cfg.Fm * 4)))
            transition = (cfg.Fm / 2) * cfg.rolloff
            order = int(cfg.resample_rej * cfg.Fs / (22 * transition))
            order = ((order + 1) // 2) * 2
            fcut = (cfg.Fm / 2) * (1 + cfg.rolloff / 2) / cfg.Fs
            coeffs = filtergen.lowpass(order, fcut)
            ftol = cfg.Fm / (cfg.Fs * decim) * 0.1
            self.resampler = FirFilterDevice(coeffs, decim, freq_tol=ftol,
                                             device=self.device)
            Fs_eff = cfg.Fs / decim
        elif cfg.decim and cfg.decim > 1:
            decim = cfg.decim
            Fs_eff = cfg.Fs / decim
        self.decim = decim
        self.Fs_eff = Fs_eff

        # The demod's route, as the JAX receiver picks it on an
        # accelerator: exact decisions (or --hard-metric) take the scan
        # demod, with --sampler rrc the polyphase fir_sampler inside it;
        # computed decisions take the demod kernel, with --sampler rrc
        # behind the matched filter; --sampler nearest and use_pallas=
        # False take the scan demod with computed decisions.
        exact = bool(cfg.exact_lut) or cfg.hard_metric
        sampler = cfg.sampler
        rrc_coeffs, rrc_steps = (), 1
        self.mf_taps = None
        if sampler == "rrc":
            if exact:
                rrc_coeffs, rrc_steps = rrc_sampler(Fs_eff, cfg)
            else:
                self.mf_taps = mf_prefilter.make_mf_taps(
                    Fs_eff, cfg.Fm, cfg.rolloff, cfg.rrc_rej)
                sampler = "linear"
        self.params = receiver.ReceiverParams(
            omega=Fs_eff / cfg.Fm,
            sampler=sampler,
            pll_adjustment=(1.0 / 6 if cfg.viterbi else 1.0),
            allow_drift=cfg.allow_drift,
            meas_decimation=(int(Fs_eff / cfg.Finfo) if cfg.Finfo
                             else 1 << 20),
            nsymbols=self.cstln.nsymbols,
            freq0=cfg.Ftune / Fs_eff,
            rrc_coeffs=rrc_coeffs,
            rrc_steps=rrc_steps,
            exact_lut=exact,
        )
        use_pallas = cfg.use_pallas
        if use_pallas is None:
            use_pallas = sampler == "linear" and not exact
        self.use_pallas = bool(use_pallas) and sampler == "linear"
        state = receiver.init_state(self.params, 1, self.device)
        if self.use_pallas:
            self._sym_consts = rk.sym_constants(self.cstln)
            self._planes = rk.pack_state(state)
            self.tables = self.state = None
        else:
            self.tables = receiver.make_tables(self.cstln, self.device)
            self.state = state
            self._planes = None
        self._meas_backlog = 0
        # --segments: chunks done (for seg_holdoff), and the segmented
        # demod's per-segment states and the segment length they are for.
        self._chunks_done = 0
        self._seg_state = None
        self._seg_nseg = 0

        on_next = None
        self.hs_state = None
        if cfg.hs:
            self.hs_params = receiver_hs.HsParams(
                omega=Fs_eff / cfg.Fm, freq0=cfg.Ftune / Fs_eff,
                meas_decimation=(int(Fs_eff / cfg.Finfo) if cfg.Finfo
                                 else 1 << 20))
            self.hs_tables = receiver_hs.hs_tables(self.device)
            self.hs_state = receiver_hs.init_state(self.hs_params, 1,
                                                   self.device)
            self.deconv = _DeconvolSyncHS(cfg.fastlock)
            mpeg = MpegSync(fastlock=True,
                            resync_period=1 if cfg.fastlock else 32)
        else:
            if cfg.viterbi:
                # FEC23 -> FEC46 for QPSK and 64APSKe (leandvb.cc:533-537)
                self.deconv = ViterbiSyncDevice(
                    self.cstln, viterbi_rate(rate, self.cstln.nsymbols),
                    fastlock=cfg.fastlock, device=self.device)
            else:
                self.deconv = _DeconvolSync(fleet_rate(rate), cfg.fastlock,
                                            debug=cfg.debug)
                on_next = self.deconv.next_sync
            mpeg = MpegSync(fastlock=cfg.fastlock, on_next_sync=on_next)
        self._ts_init(mpeg)
        if cfg.hdlc:
            # ETR192 descrambler state (shift register, counter) and the
            # HDLC deframer; on the --hs path too, whose bytes reach the
            # same byte stages (the JAX receiver builds them on the other
            # paths only, so its --hs --hdlc fails on the first bytes).
            self.hdlc_sync = HdlcSync(2, 278, fastlock=cfg.fastlock,
                                      header16=cfg.packetized)
            self.hdlc_sync.debug = cfg.debug
            self.etr_state = (0, 0)
            self.hdlc_frames = np.empty(0, np.uint8)

        self.sample_backlog = np.empty((0, 2), np.float32)
        self.first_derand = True
        # VBER window ~ twice/second, at least 50000 bits (leandvb.cc:585)
        self.vber_est = RateEstimator(max(int(cfg.Fm / 2), 50000))
        self.vbitcount = 0
        self.verrcount = 0
        self.meas = {"freq": [], "ss": [], "mer": [], "vber": [],
                     "cnr": []}
        self.spectrum_lines = []     # [1024] dB lines for --fd-spectrum
        self.sampled_points = []     # (re, im) for --fd-const SYMBOLS
        self._reads = 0              # process() calls so far

    @property
    def readahead(self) -> int:
        """Samples past a chunk the demod (and matched filter) read."""
        ra = self.params.readahead
        if self.mf_taps is not None:
            ra += len(self.mf_taps) - 1
        return ra

    @property
    def dem_state(self):
        """The demod's state: [19, 1] planes (kernel) or the scan dict."""
        return self._planes if self.use_pallas else self.state

    @dem_state.setter
    def dem_state(self, st):
        if self.use_pallas:
            self._planes = st
        else:
            self.state = st

    # -- streaming API -----------------------------------------------------

    def process(self, iq: np.ndarray) -> np.ndarray:
        """Feed [n, 2] float32 IQ; returns TS packets [k, 188] decoded so
        far."""
        inp = trace.begin(self._reads)
        self._reads += 1
        with inp, trace.span("rx.process"):
            trace.count("rx.reads")
            if self.cfg.hs:
                return self._process_hs(iq)
            with trace.span("rx.preprocess"):
                iq = np.asarray(iq, dtype=np.float32) * np.float32(
                    self.cfg.float_scale)
                iq = self._preprocess(iq)
            if self.cfg.fd_pp >= 0:
                # --fd-pp: the preprocessed cf32 stream (p_preprocessed,
                # leandvb.cc:418-422): what feeds the demodulator.
                os.write(self.cfg.fd_pp, np.ascontiguousarray(
                    iq, np.float32).tobytes())
            S = self.cfg.segments
            seg_live = S > 1 and self._chunks_done >= self.cfg.seg_holdoff
            with trace.span("rx.ingest"):
                xd = self._ingest(iq, S if seg_live else 1)
            if xd is None:
                return np.empty((0, TS_SIZE), np.uint8)
            n = xd.shape[1] - self.readahead
            # multi_rx imports this module, so its engine is imported here.
            from .multi_rx import _SEG_T, _demod_segmented, init_seg_state
            if seg_live and n // S >= self.cfg.seg_warmup + _SEG_T:
                # The fleet's time-segmented demod on one carrier.
                nseg = n // S
                if self._seg_state is None or self._seg_nseg != nseg:
                    self._seg_state = init_seg_state(self.dem_state, 1, S,
                                                     nseg)
                    self._seg_nseg = nseg
                with trace.span("rx.demod"):
                    (self.dem_state, self._seg_state, sym, valid,
                     cost) = _demod_segmented(
                        self.params, getattr(self, "_sym_consts", None),
                        self.mf_taps, 1, S, self.cfg.seg_warmup,
                        self.cfg.viterbi, self.dem_state, self._seg_state, xd,
                        tables=self.tables)
                with trace.span("rx.fetch"):
                    valid = _host_copy(valid[:, 0])
                    syms = _host_copy(sym[:, 0])[valid]
                    costs = (_host_copy(cost[:, 0])[valid]
                             if self.cfg.viterbi else None)
                with trace.span("rx.meas"):
                    self._meas_snapshot(n)
            else:
                # A sequential call moves the stream past the persisted
                # per-segment positions: rebuild them at the next segmented
                # call.
                self._seg_state = None
                if self.mf_taps is not None:
                    with trace.span("rx.mf"):
                        freqw = (self._planes[2] if self.use_pallas
                                 else self.state["freqw"])
                        xd = mf_prefilter.mf_prefilter(self.mf_taps, freqw, xd)
                if self.use_pallas:
                    with trace.span("rx.demod"):
                        self._planes, packed = rk.demod(
                            self.params, self._sym_consts, self._planes, xd)
                    with trace.span("rx.fetch"):
                        p = _host_copy(packed[:, 0])
                    valid = ((p >> 24) & 1).astype(bool)
                    syms = ((p >> 16) & 0xFF).astype(np.uint8)[valid]
                    costs = (-(p & 0xFFFF)).astype(np.int16)[valid]
                    with trace.span("rx.meas"):
                        self._meas_snapshot(n)
                else:
                    with trace.span("rx.demod"):
                        self.state, out = receiver.run_chunks(
                            self.params, self.tables, self.state, xd)
                    with trace.span("rx.fetch"):
                        valid = _host_copy(out["valid"][0])
                        syms = _host_copy(out["symbol"][0])[valid]
                        costs = _host_copy(out["cost"][0])[valid]
                    with trace.span("rx.meas"):
                        self._collect_meas(out)
            self._chunks_done += 1

            with trace.span("rx.deconv"):
                if self.cfg.viterbi:
                    bytes_out = self.deconv.process(syms, costs)
                else:
                    bytes_out = self.deconv.process(syms)
            with trace.span("rx.bytes"):
                return self._byte_stages(bytes_out)

    def _ingest(self, iq: np.ndarray, S: int):
        """The sample backlog and the copy of its whole chunks (a multiple
        of S, with the readahead) to the device as [1, n + ra, 2]; None
        until a chunk is buffered."""
        self.sample_backlog = np.concatenate([self.sample_backlog, iq])
        ra = self.readahead
        K = (len(self.sample_backlog) - ra) // receiver.CHUNK
        K -= K % S                      # nseg must stay CHUNK-aligned
        if K <= 0:
            return None
        n = K * receiver.CHUNK
        x = np.ascontiguousarray(self.sample_backlog[: n + ra][None])
        self.sample_backlog = self.sample_backlog[n:]
        trace.count("rx.h2d_bytes", x.nbytes)
        return torch.from_numpy(x).to(self.device)

    def _meas_snapshot(self, n: int):
        """Measurement snapshots from the demod state at the scan path's
        meas_decimation cadence (the kernel's and the segmented demod's
        outputs carry no freq/ss/mer): the --fd-info stream and the
        resampler's freq_tap."""
        self._meas_backlog += n
        k = self._meas_backlog // self.params.meas_decimation
        if not k:
            return
        self._meas_backlog %= self.params.meas_decimation
        if self.use_pallas:
            st = self._planes[:, 0].cpu().numpy()
            freqw, est_insp, est_sp, est_ep = st[2], st[4], st[5], st[6]
        else:
            freqw, est_insp, est_sp, est_ep = (
                self.state[k2][0].cpu().numpy()
                for k2 in ("freqw", "est_insp", "est_sp", "est_ep"))
        mer = 10 * np.log10(est_sp / est_ep) if est_ep > 0 else 0.0
        for _ in range(int(k)):
            self.meas["freq"].append(float(freqw / 65536.0))
            self.meas["ss"].append(float(np.sqrt(est_insp)))
            self.meas["mer"].append(float(mer))

    def _collect_meas(self, out: dict):
        """The scan's per-chunk measurements, `nmeas` times each (and, for
        --fd-const, its one sampled point per chunk: p_sampled /
        cstln_out, sdr.h:860-861)."""
        nmeas = out["nmeas"][0].cpu().numpy()
        if nmeas.any():
            freq, ss, mer = (out[k][0].cpu().numpy()
                             for k in ("freq", "ss", "mer"))
            for k in np.nonzero(nmeas)[0]:
                for _ in range(int(nmeas[k])):
                    self.meas["freq"].append(float(freq[k]))
                    self.meas["ss"].append(float(ss[k]))
                    self.meas["mer"].append(float(mer[k]))
        if self.cfg.want_const:
            pts = out["sampled"][0].cpu().numpy()
            self.sampled_points.extend(map(tuple, pts))

    def _process_hs(self, iq: np.ndarray) -> np.ndarray:
        """--hs path (run_highspeed, leandvb.cc:727-969): u8 IQ only."""
        # Undo the u8 -> float conversion of the ingest stage.
        u8 = (np.asarray(iq, np.float32) + 128.0).astype(np.int32)
        self.sample_backlog = np.concatenate(
            [self.sample_backlog, u8.astype(np.float32)])
        K = (len(self.sample_backlog) - 1) // receiver_hs.CHUNK
        if K <= 0:
            return np.empty((0, TS_SIZE), np.uint8)
        n = K * receiver_hs.CHUNK
        x = self.sample_backlog[: n + 1].astype(np.int32)
        self.sample_backlog = self.sample_backlog[n:]
        self.hs_state, out = receiver_hs.run_chunks_hs(
            self.hs_params, self.hs_tables, self.hs_state,
            torch.from_numpy(x[None]).to(self.device))
        valid = out["valid"][0].cpu().numpy()
        syms = out["symbol"][0].cpu().numpy()[valid]
        nmeas = out["nmeas"][0].cpu().numpy()
        if nmeas.any():
            freq = out["freq"][0].cpu().numpy()
            for k in np.nonzero(nmeas)[0]:
                self.meas["freq"].append(float(freq[k]))
        if self.cfg.want_const:
            # cstln_out (fast_qpsk_receiver, sdr.h:1120-1122): one
            # interpolated point per chunk, u8-centered -> centered.
            ok = out["sampled_ok"][0].cpu().numpy()
            sp = out["sampled"][0].cpu().numpy()[ok] - 128
            self.sampled_points.extend((float(p[0]), float(p[1]))
                                       for p in sp[-64:])
        return self._byte_stages(self.deconv.process(syms))

    def _preprocess(self, iq: np.ndarray) -> np.ndarray:
        """Noise / notch / derotation / CNR / spectrum / resample /
        decimation (mirrors the p_preprocessed chain, leandvb.cc:
        277-399)."""
        if self.cfg.awgn:
            # Continue the drand48 stream across reads (jump to the state
            # after the draws consumed so far, dsp.h:172-183).
            noise, used = chansim.wgn_c(
                len(iq), self.cfg.awgn,
                seed=chansim.drand48_jump(self.noise_draws))
            self.noise_draws += used
            iq = iq + noise
        if not (self.notch or self.derot or self.cnr_est or self.spectrum
                or self.resampler or self.decim > 1):
            return iq
        z = iq[:, 0] + 1j * iq[:, 1]
        if self.notch:
            with trace.span("rx.notch"):
                z = self.notch.process(z)
        if self.derot:
            z = self.derot.process(z)
        freq_tap = self.meas["freq"][-1] if self.meas["freq"] else 0.0
        if self.cnr_est:
            self.meas["cnr"].extend(
                self.cnr_est.process(z, freq_tap / self.decim))
        if self.spectrum:
            self.spectrum_lines.extend(self.spectrum.process(z))
        if self.resampler is not None:
            z = self.resampler.process(z, freq_tap / self.decim)
        elif self.decim > 1:
            z = blocks.decimate(z, self.decim)
        return np.stack([z.real, z.imag], axis=-1).astype(np.float32)

    def _byte_stages(self, bytes_out: np.ndarray) -> np.ndarray:
        """MPEG sync -> deinterleave -> RS -> derandomize (host); with
        --hdlc instead ETR192 descramble -> HDLC deframe (leandvb.cc:
        546-556), whose frames gather in `hdlc_frames` (no TS out)."""
        if self.cfg.hdlc:
            if len(bytes_out):
                sr, ctr = self.etr_state
                descr, sr, ctr = etr192_descramble(bytes_out, sr, ctr)
                self.etr_state = (sr, ctr)
                self.hdlc_frames = np.concatenate(
                    [self.hdlc_frames, self.hdlc_sync.process(descr)])
            return np.empty((0, TS_SIZE), np.uint8)
        pkts, failed, bits = self._ts_stages(bytes_out)
        if failed is not None:
            trace.count("rx.rs_failed", int(failed.sum()))
            if self.cfg.debug:
                # Per-packet RS classification glyphs (dvb.h:1029-1038):
                # '_' clean, '.' corrected, '!' still corrupted.
                sys.stderr.write("".join(
                    "!" if f else ("." if b else "_")
                    for f, b in zip(failed, bits)))
                sys.stderr.flush()
            nbits = len(failed) * RS_SIZE * 8
            self.vbitcount += nbits
            self.verrcount += int(bits.sum())
            self.vber_est.update(int(bits.sum()), nbits)
        return pkts

    @property
    def lock(self) -> bool:
        return self.mpeg.synchronized

    @property
    def locktime(self) -> int:
        return self.mpeg.locktime

    @property
    def vber(self) -> float:
        """Windowed VBER like the reference's rate_estimator; the
        cumulative ratio before the first full window."""
        if self.vber_est.latest is not None:
            return self.vber_est.latest
        return self.verrcount / self.vbitcount if self.vbitcount else 0.0

    def stats(self) -> dict:
        """Per-stage progress counters (the sch.dump() equivalent,
        framework.h:115-121): totals and backlog fill levels."""
        return {
            "sample_backlog": int(len(self.sample_backlog)),
            "symbol_backlog": int(len(getattr(
                self.deconv, "backlog", getattr(self.deconv, "sym_backlog",
                                                [])))),
            "byte_backlog": int(len(self.byte_backlog)),
            "mpegbyte_backlog": int(len(self.mpegbyte_backlog)),
            "vbitcount": self.vbitcount,
            "verrcount": self.verrcount,
            "lock": self.lock,
            "locktime": self.locktime,
        }

    # -- checkpoint / resume ----------------------------------------------

    def _deconv_state(self) -> dict:
        if not self.cfg.viterbi or self.cfg.hs:
            return {k: getattr(self.deconv, k) for k in self.deconv.STATE}
        d = {k: getattr(self.deconv, k) for k in self.VITERBI_STATE}
        dev = getattr(self.deconv, "_dev_state", None)
        d["planes"] = (None if dev is None else
                       dict(zip(self.deconv.plane_keys,
                                (t.cpu().numpy() for t in dev))))
        return d

    def _set_deconv_state(self, d: dict):
        if not self.cfg.viterbi or self.cfg.hs:
            for k in self.deconv.STATE:
                setattr(self.deconv, k, d[k])
            return
        for k in self.VITERBI_STATE:
            setattr(self.deconv, k, d[k])
        if d["planes"] is None:
            if hasattr(self.deconv, "_dev_state"):
                del self.deconv._dev_state
            return
        self.deconv._dev_state = tuple(
            torch.from_numpy(np.ascontiguousarray(d["planes"][k], np.int32))
            .to(self.device) for k in self.deconv.plane_keys)

    def save_state(self) -> bytes:
        """Serialize every mutable piece of the receiver: demod state
        (planes or the scan dict; the --hs state), the preprocessing
        blocks, all host FSMs and stream backlogs."""
        aux = {}
        if self.notch is not None:
            b = self.notch.b
            aux["notch"] = {"slot_i": b.slot_i, "estim": b.estim,
                            "gain": b.gain, "phase": b.phase,
                            "backlog": b.backlog.buf}
        if self.derot is not None:
            aux["derot"] = {"index": self.derot.index}
        for name in ("cnr_est", "spectrum"):
            blk = getattr(self, name)
            if blk is not None:
                aux[name] = {"avgpower": blk.b.avgpower, "phase": blk.b.phase,
                             "backlog": blk.b.backlog.buf}
        if self.resampler is not None:
            aux["resampler"] = self.resampler.state()
        if self.hs_state is not None:
            aux["hs_state"] = state_to_numpy(self.hs_state)
        if self.cfg.hdlc:
            aux["etr_state"] = self.etr_state
            aux["hdlc_sync"] = self.hdlc_sync.__dict__
        return pickle.dumps({
            "format": CHECKPOINT_FORMAT,
            "use_pallas": self.use_pallas,
            "dev": state_to_numpy(self.dem_state),
            "chunks_done": self._chunks_done,
            "seg_state": (None if self._seg_state is None
                          else state_to_numpy(self._seg_state)),
            "seg_nseg": self._seg_nseg,
            "meas_backlog": self._meas_backlog,
            "sample_backlog": self.sample_backlog,
            "byte_backlog": self.byte_backlog,
            "mpegbyte_backlog": self.mpegbyte_backlog,
            "derand_pos": self.derand_pos,
            "first_derand": self.first_derand,
            "noise_draws": self.noise_draws,
            "deconv": self._deconv_state(),
            "mpeg": {k: v for k, v in self.mpeg.__dict__.items()
                     if k != "on_next_sync"},
            "vbitcount": self.vbitcount,
            "verrcount": self.verrcount,
            "meas": self.meas,
            "aux": aux,
        })

    def load_state(self, blob: bytes) -> None:
        d = pickle.loads(blob)
        if d.get("format") != CHECKPOINT_FORMAT:
            raise ValueError(
                f"not a {CHECKPOINT_FORMAT} checkpoint (a leansdr_tpu "
                "checkpoint goes through convert.from_jax_dvbs_checkpoint)")
        # The demod state as this receiver's route keeps it: [19, 1]
        # planes or the scan dict (either converts to the other, but for
        # the rrc sampler's state, which only a scan dict carries).
        self.dem_state = state_from_numpy(d["dev"], self.use_pallas,
                                          self.params, self.device)
        # A JAX checkpoint carries no segment state (a JAX receiver that
        # loads one starts its holdoff count and segment states afresh).
        self._chunks_done = d.get("chunks_done", 0)
        seg = d.get("seg_state")
        self._seg_state = (None if seg is None else state_from_numpy(
            seg, self.use_pallas, self.params, self.device))
        self._seg_nseg = d.get("seg_nseg", 0)
        self._meas_backlog = d["meas_backlog"]
        self.sample_backlog = d["sample_backlog"]
        self.byte_backlog = d["byte_backlog"]
        self.mpegbyte_backlog = d["mpegbyte_backlog"]
        self.derand_pos = d["derand_pos"]
        self.first_derand = d["first_derand"]
        self.noise_draws = d.get("noise_draws", 0)
        self._set_deconv_state(d["deconv"])
        self.mpeg.__dict__.update(d["mpeg"])
        self.vbitcount = d["vbitcount"]
        self.verrcount = d["verrcount"]
        self.meas = d["meas"]
        aux = d["aux"]
        for name in ("notch", "derot", "cnr_est", "spectrum", "resampler"):
            if (name in aux) != (getattr(self, name) is not None):
                raise ValueError(f"checkpoint {name} state does not match "
                                 "this receiver's configuration")
        if "notch" in aux:
            b, st = self.notch.b, aux["notch"]
            b.slot_i = np.asarray(st["slot_i"], np.int32)
            b.estim = np.asarray(st["estim"], np.float32)
            b.gain = np.asarray(st["gain"], np.float32)
            b.phase = int(st["phase"])
            b.backlog.buf = np.asarray(st["backlog"], np.float32)
        if "derot" in aux:
            self.derot.index = int(aux["derot"]["index"])
        for name in ("cnr_est", "spectrum"):
            if name in aux:
                b, st = getattr(self, name).b, aux[name]
                b.avgpower = (None if st["avgpower"] is None
                              else np.asarray(st["avgpower"], np.float32))
                b.phase = int(st["phase"])
                b.backlog.buf = np.asarray(st["backlog"], np.float32)
        if "resampler" in aux:
            self.resampler.set_state(aux["resampler"])
        if ("etr_state" in aux) != bool(self.cfg.hdlc):
            raise ValueError("checkpoint --hdlc state does not match this "
                             "receiver's configuration")
        if "etr_state" in aux:
            self.etr_state = tuple(aux["etr_state"])
            self.hdlc_sync.__dict__.update(aux["hdlc_sync"])
        if ("hs_state" in aux) != (self.hs_state is not None):
            raise ValueError("checkpoint --hs state does not match this "
                             "receiver's configuration")
        if "hs_state" in aux:
            self.hs_state = {
                k: torch.from_numpy(np.array(v)).to(self.device)
                for k, v in aux["hs_state"].items()}
