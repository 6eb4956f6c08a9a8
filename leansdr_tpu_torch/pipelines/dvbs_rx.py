"""The single-carrier DVB-S receiver (the leandvb equivalent, reference
leandvb.cc:157-724), and RxConfig: the counterpart of
leansdr_tpu/pipelines/dvbs_rx.py on its kernel path (use_pallas=True,
exact_lut=False).

Chain per call of `DvbsReceiver.process`:

  IQ [n, 2] float32 -> float scale
    -> preprocessing (host unless noted): auto-notch (dsp/blocks_device:
       cuFFT detection, device trackers), derotation (dsp/blocks.Rotator),
       --resample (dsp/fir_kernel.FirFilterDevice on csrc/fir.cu) or
       --decim
    -> [--sampler rrc] matched filter (dsp/mf_prefilter.py)
    -> demod kernel (csrc/demod.cu) on [1, n + readahead, 2], or with
       `segments=S` (--segments) the fleet's time-segmented demod
       (pipelines/multi_rx._demod_segmented): the call's samples as S
       lane-parallel segments, two launches
    -> hard symbols: algebraic deconvolution (fec/deconv.py, host), or
       soft symbols: ViterbiSyncDevice (fec/viterbi.py) on the fleet's
       ACS kernels (csrc/acs.cu at 1/2, csrc/acs_banked.cu otherwise)
    -> MPEG sync (proto/framing.py) -> deinterleave -> RS(204,188)
       -> derandomize (fec/, host NumPy) -> TS packets.

Measurements (FREQ/SS/MER) are snapshots of the demod's state planes at
the meas_decimation cadence, which also feeds the resampler's carrier
tracking (freq_tap), exactly as the JAX kernel path takes them.

Unlike the fleet, this receiver honours `allow_drift` (--drift), as the
JAX single-carrier receiver does (leansdr_tpu/pipelines/dvbs_rx.py:302).
"""

import os
import pickle
import sys
from dataclasses import dataclass

import numpy as np
import torch

from .. import device as _dev
from ..core.generic import RateEstimator
from ..dsp import blocks, filtergen, mf_prefilter, receiver
from ..dsp import receiver_kernel as rk
from ..dsp.blocks_device import AutoNotch1
from ..dsp.cstln import Predef, make_dvbs2_constellation
from ..dsp.fir_kernel import FirFilterDevice
from ..fec import deconv, interleave, prbs, rs
from ..fec.viterbi import ViterbiSyncDevice
from ..fec.viterbi_banked import fleet_rate
from ..proto.framing import MpegSync

TS_SIZE = 188
RS_SIZE = 204
CHECKPOINT_FORMAT = "leansdr_tpu_torch.dvbs_rx/1"
RATES = ("1/2", "2/3", "3/4", "5/6", "7/8")     # the DVB-S code rates


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
    # True: the bit-exact trig16/256x256-LUT decision path; False: the
    # computed path of the demod kernel. Must be given explicitly (the
    # JAX package resolves None from its backend; the CLI says False).
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


def _unsupported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1 item {item}); the "
        "single-carrier port runs QPSK with the demod kernel "
        "(exact_lut=False, sampler linear or rrc; sequential or "
        "segmented), hard or Viterbi decoding, anf/derotate/resample/"
        "decim preprocessing")


def _check_config(cfg: RxConfig):
    if cfg.exact_lut is None:
        raise ValueError("RxConfig.exact_lut must be given explicitly "
                         "(False: the computed demod path)")
    if cfg.seg_warmup % receiver.CHUNK:
        raise ValueError(
            f"seg_warmup must be a multiple of {receiver.CHUNK}")
    if cfg.hs:
        _unsupported("the --hs fast-QPSK receiver", "12")
    if cfg.exact_lut or cfg.hard_metric:
        _unsupported("the exact-LUT scan demod (exact_lut, hard_metric)",
                     "10")
    if cfg.sampler not in ("linear", "rrc"):
        _unsupported(f"sampler={cfg.sampler!r}", "10")
    if cfg.use_pallas is False:
        _unsupported("a demod without the kernel (use_pallas=False)", "10")
    if cfg.awgn:
        _unsupported("--awgn (the drand48 noise stream of "
                     "pipelines/chansim.py)", "22")
    if cfg.cnr or cfg.want_spectrum:
        _unsupported("--cnr and --fd-spectrum", "13")
    if cfg.hdlc:
        _unsupported("--hdlc (proto/hdlc.py)", "21")
    if cfg.constellation != Predef.QPSK or cfg.rate not in RATES:
        _unsupported(f"{Predef(cfg.constellation).name} rate {cfg.rate}",
                     "20")


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


class DvbsReceiver:
    """Single-carrier streaming receiver on the device kernels. Entry
    points run on `device` (default CUDA; CUDA without a GPU raises)."""

    # The streaming fields of the Viterbi decoder a checkpoint carries.
    VITERBI_STATE = ("current", "resync_phase", "sym_backlog",
                     "cost_backlog")

    def __init__(self, cfg: RxConfig, device=None):
        self.device = _dev.resolve_device(device)
        _check_config(cfg)
        self.cfg = cfg
        rate = cfg.rate
        self.cstln = make_dvbs2_constellation(cfg.constellation, rate)

        # ---- preprocessing chain (leandvb.cc:277-399) ----
        self.notch = (AutoNotch1(cfg.anf, 0.0, device=self.device)
                      if cfg.anf else None)
        self.derot = (blocks.Rotator(-cfg.Fderot / cfg.Fs)
                      if cfg.Fderot else None)
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

        # --sampler rrc: the matched filter as a device convolution, then
        # the linear-sampler kernel.
        self.mf_taps = None
        if cfg.sampler == "rrc":
            self.mf_taps = mf_prefilter.make_mf_taps(
                Fs_eff, cfg.Fm, cfg.rolloff, cfg.rrc_rej)
        self.params = receiver.ReceiverParams(
            omega=Fs_eff / cfg.Fm,
            sampler="linear",
            pll_adjustment=(1.0 / 6 if cfg.viterbi else 1.0),
            allow_drift=cfg.allow_drift,
            meas_decimation=(int(Fs_eff / cfg.Finfo) if cfg.Finfo
                             else 1 << 20),
            nsymbols=self.cstln.nsymbols,
            freq0=cfg.Ftune / Fs_eff,
            exact_lut=False,
        )
        self._sym_consts = rk.sym_constants(self.cstln)
        self._planes = rk.pack_state(receiver.init_state(self.params, 1,
                                                         self.device))
        self._meas_backlog = 0
        # --segments: chunks done (for seg_holdoff), and the segmented
        # demod's per-segment states and the segment length they are for.
        self._chunks_done = 0
        self._seg_state = None
        self._seg_nseg = 0

        if cfg.viterbi:
            # FEC23 -> FEC46 for QPSK (leandvb.cc:533-537)
            self.deconv = ViterbiSyncDevice(self.cstln, fleet_rate(rate),
                                            fastlock=cfg.fastlock,
                                            device=self.device)
            on_next = None
        else:
            self.deconv = _DeconvolSync(fleet_rate(rate), cfg.fastlock,
                                        debug=cfg.debug)
            on_next = self.deconv.next_sync
        self.mpeg = MpegSync(fastlock=cfg.fastlock, on_next_sync=on_next)

        self.sample_backlog = np.empty((0, 2), np.float32)
        self.byte_backlog = np.empty(0, np.uint8)       # deconv -> mpeg_sync
        self.mpegbyte_backlog = np.empty(0, np.uint8)   # mpeg -> deinterleave
        self.derand_pos = 0
        self.first_derand = True
        # VBER window ~ twice/second, at least 50000 bits (leandvb.cc:585)
        self.vber_est = RateEstimator(max(int(cfg.Fm / 2), 50000))
        self.vbitcount = 0
        self.verrcount = 0
        self.meas = {"freq": [], "ss": [], "mer": [], "vber": [],
                     "cnr": []}

    @property
    def readahead(self) -> int:
        """Samples past a chunk the demod (and matched filter) read."""
        ra = self.params.readahead
        if self.mf_taps is not None:
            ra += len(self.mf_taps) - 1
        return ra

    # -- streaming API -----------------------------------------------------

    def process(self, iq: np.ndarray) -> np.ndarray:
        """Feed [n, 2] float32 IQ; returns TS packets [k, 188] decoded so
        far."""
        iq = np.asarray(iq, dtype=np.float32) * np.float32(
            self.cfg.float_scale)
        iq = self._preprocess(iq)
        if self.cfg.fd_pp >= 0:
            # --fd-pp: the preprocessed cf32 stream (p_preprocessed,
            # leandvb.cc:418-422): what feeds the demodulator.
            os.write(self.cfg.fd_pp, np.ascontiguousarray(
                iq, np.float32).tobytes())
        self.sample_backlog = np.concatenate([self.sample_backlog, iq])

        ra = self.readahead
        K = (len(self.sample_backlog) - ra) // receiver.CHUNK
        S = self.cfg.segments
        seg_live = S > 1 and self._chunks_done >= self.cfg.seg_holdoff
        if seg_live:
            K -= K % S                  # nseg must stay CHUNK-aligned
        if K <= 0:
            return np.empty((0, TS_SIZE), np.uint8)
        n = K * receiver.CHUNK
        x = self.sample_backlog[: n + ra]
        self.sample_backlog = self.sample_backlog[n:]

        xd = torch.from_numpy(np.ascontiguousarray(x[None])).to(self.device)
        # multi_rx imports this module, so its engine is imported here.
        from .multi_rx import _SEG_T, _demod_segmented, init_seg_state
        if seg_live and n // S >= self.cfg.seg_warmup + _SEG_T:
            # The fleet's time-segmented demod on one carrier.
            nseg = n // S
            if self._seg_state is None or self._seg_nseg != nseg:
                self._seg_state = init_seg_state(self._planes, 1, S, nseg)
                self._seg_nseg = nseg
            (self._planes, self._seg_state, sym, valid,
             cost) = _demod_segmented(
                self.params, self._sym_consts, self.mf_taps, 1, S,
                self.cfg.seg_warmup, self.cfg.viterbi, self._planes,
                self._seg_state, xd)
            valid = valid[:, 0].cpu().numpy()
            syms = sym[:, 0].cpu().numpy()[valid]
            costs = (cost[:, 0].cpu().numpy()[valid] if self.cfg.viterbi
                     else None)
        else:
            # A sequential call moves the stream past the persisted
            # per-segment positions: rebuild them at the next segmented
            # call.
            self._seg_state = None
            if self.mf_taps is not None:
                xd = mf_prefilter.mf_prefilter(self.mf_taps,
                                               self._planes[2], xd)
            self._planes, packed = rk.demod(self.params, self._sym_consts,
                                            self._planes, xd)
            p = packed[:, 0].cpu().numpy()
            valid = ((p >> 24) & 1).astype(bool)
            syms = ((p >> 16) & 0xFF).astype(np.uint8)[valid]
            costs = (-(p & 0xFFFF)).astype(np.int16)[valid]
        self._chunks_done += 1

        # Measurement snapshots from the state planes at the scan path's
        # meas_decimation cadence (the kernel's output carries no
        # freq/ss/mer): the --fd-info stream and the resampler's freq_tap.
        self._meas_backlog += n
        k = self._meas_backlog // self.params.meas_decimation
        if k:
            self._meas_backlog %= self.params.meas_decimation
            st = self._planes[:, 0].cpu().numpy()
            mer = 10 * np.log10(st[5] / st[6]) if st[6] > 0 else 0.0
            for _ in range(int(k)):
                self.meas["freq"].append(float(st[2] / 65536.0))
                self.meas["ss"].append(float(np.sqrt(st[4])))
                self.meas["mer"].append(float(mer))

        if self.cfg.viterbi:
            bytes_out = self.deconv.process(syms, costs)
        else:
            bytes_out = self.deconv.process(syms)
        return self._byte_stages(bytes_out)

    def _preprocess(self, iq: np.ndarray) -> np.ndarray:
        """Notch / derotation / resample / decimation (mirrors the
        p_preprocessed chain, leandvb.cc:277-399)."""
        if not (self.notch or self.derot or self.resampler
                or self.decim > 1):
            return iq
        z = iq[:, 0] + 1j * iq[:, 1]
        if self.notch:
            z = self.notch.process(z)
        if self.derot:
            z = self.derot.process(z)
        freq_tap = self.meas["freq"][-1] if self.meas["freq"] else 0.0
        if self.resampler is not None:
            z = self.resampler.process(z, freq_tap / self.decim)
        elif self.decim > 1:
            z = blocks.decimate(z, self.decim)
        return np.stack([z.real, z.imag], axis=-1).astype(np.float32)

    def _byte_stages(self, bytes_out: np.ndarray) -> np.ndarray:
        """MPEG sync -> deinterleave -> RS -> derandomize (host)."""
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
            return np.empty((0, TS_SIZE), np.uint8)
        msgs, failed, bits = rs.decode(rspkts)
        if self.cfg.debug:
            # Per-packet RS classification glyphs (dvb.h:1029-1038):
            # '_' clean, '.' corrected, '!' still corrupted.
            sys.stderr.write("".join(
                "!" if f else ("." if b else "_")
                for f, b in zip(failed, bits)))
            sys.stderr.flush()
        self.vbitcount += rspkts.shape[0] * RS_SIZE * 8
        self.verrcount += int(bits.sum())
        self.vber_est.update(int(bits.sum()), rspkts.shape[0] * RS_SIZE * 8)
        # Corrupted packets keep flowing with a marked sync byte so the
        # derandomizer keeps phase (dvb.h:1043-1046).
        msgs = msgs.copy()
        msgs[failed, 0] ^= prbs.MPEG_SYNC_CORRUPTED
        out, good, self.derand_pos = prbs.derandomize_np(msgs,
                                                         self.derand_pos)
        return out[good]

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
        if not self.cfg.viterbi:
            return {k: getattr(self.deconv, k) for k in _DeconvolSync.STATE}
        d = {k: getattr(self.deconv, k) for k in self.VITERBI_STATE}
        dev = getattr(self.deconv, "_dev_state", None)
        d["planes"] = (None if dev is None else
                       dict(zip(self.deconv.plane_keys,
                                (t.cpu().numpy() for t in dev))))
        return d

    def _set_deconv_state(self, d: dict):
        if not self.cfg.viterbi:
            for k in _DeconvolSync.STATE:
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
        planes, the preprocessing blocks, all host FSMs and stream
        backlogs."""
        aux = {}
        if self.notch is not None:
            b = self.notch.b
            aux["notch"] = {"slot_i": b.slot_i, "estim": b.estim,
                            "gain": b.gain, "phase": b.phase,
                            "backlog": b.backlog.buf}
        if self.derot is not None:
            aux["derot"] = {"index": self.derot.index}
        if self.resampler is not None:
            aux["resampler"] = self.resampler.state()
        return pickle.dumps({
            "format": CHECKPOINT_FORMAT,
            "dev": self._planes.cpu().numpy(),
            "chunks_done": self._chunks_done,
            "seg_state": (None if self._seg_state is None
                          else self._seg_state.cpu().numpy()),
            "seg_nseg": self._seg_nseg,
            "meas_backlog": self._meas_backlog,
            "sample_backlog": self.sample_backlog,
            "byte_backlog": self.byte_backlog,
            "mpegbyte_backlog": self.mpegbyte_backlog,
            "derand_pos": self.derand_pos,
            "first_derand": self.first_derand,
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
        self._planes = torch.from_numpy(
            np.ascontiguousarray(d["dev"], np.float32)).to(self.device)
        # A JAX checkpoint carries no segment state (a JAX receiver that
        # loads one starts its holdoff count and segment states afresh).
        self._chunks_done = d.get("chunks_done", 0)
        seg = d.get("seg_state")
        self._seg_state = (None if seg is None else torch.from_numpy(
            np.ascontiguousarray(seg, np.float32)).to(self.device))
        self._seg_nseg = d.get("seg_nseg", 0)
        self._meas_backlog = d["meas_backlog"]
        self.sample_backlog = d["sample_backlog"]
        self.byte_backlog = d["byte_backlog"]
        self.mpegbyte_backlog = d["mpegbyte_backlog"]
        self.derand_pos = d["derand_pos"]
        self.first_derand = d["first_derand"]
        self._set_deconv_state(d["deconv"])
        self.mpeg.__dict__.update(d["mpeg"])
        self.vbitcount = d["vbitcount"]
        self.verrcount = d["verrcount"]
        self.meas = d["meas"]
        aux = d["aux"]
        for name in ("notch", "derot", "resampler"):
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
        if "resampler" in aux:
            self.resampler.set_state(aux["resampler"])
