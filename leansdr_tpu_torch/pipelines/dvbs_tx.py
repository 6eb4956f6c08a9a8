"""DVB-S modulator pipeline (reference leandvbtx.cc:79-197; a copy of
leansdr_tpu/pipelines/dvbs_tx.py: the batch `modulate` that makes the
port's own stimulus, and the streaming `TxStream` of leandvbtx).

TS packets -> energy-dispersal randomizer -> RS(204,188) encoder ->
Forney interleaver -> punctured convolutional encoder -> constellation
mapper -> zero-stuffed polyphase RRC interpolation -> (optional decimation,
AGC) -> IQ samples.

The byte-domain stages are exact integer ops; the RRC resampler is a
polyphase FIR identical in alignment to fir_resampler (dsp.h:306-337):
the first output corresponds to input symbol index (ncoeffs+interp)/interp
and output count is (nsym*interp - ncoeffs)/interp symbols' worth.
"""

from dataclasses import dataclass

import numpy as np

from ..fec import prbs, rs, interleave, convenc
from ..dsp import filtergen
from ..dsp.cstln import Predef, CSTLN_AMP, make_dvbs2_constellation


@dataclass
class TxConfig:
    constellation: Predef = Predef.QPSK
    rate: str = "1/2"
    amp: float = 1.0          # RMS amplitude (from --power dB)
    agc: bool = False
    interp: int = 2
    decim: int = 1
    rolloff: float = 0.35
    rrc_rej: float = 10.0


def modulate(packets: np.ndarray, cfg: TxConfig) -> np.ndarray:
    """TS packets [n,188] -> float32 IQ [m,2]. Whole-stream, stateless."""
    rate = cfg.rate
    cstln = make_dvbs2_constellation(cfg.constellation, rate)
    bps = cstln.bits_per_symbol
    # Rate 2/3 handled as 4/6 for QPSK/64APSKe (leandvbtx.cc:115-119).
    if rate == "2/3" and cstln.nsymbols in (4, 64):
        rate = "4/6"

    randomized, _ = prbs.randomize(np.asarray(packets, np.uint8), 0)
    rspackets = rs.encode(randomized)                       # [n,204]
    ilv_bytes, _ = interleave.interleave(rspackets)         # [(n-11)*204]
    # dvb_convol processes whole multiples of bits_in bytes (dvb.h:589-594).
    bits_in, _ = convenc.FEC_SPECS[rate]
    ilv_bytes = ilv_bytes[: len(ilv_bytes) // bits_in * bits_in]
    symbols, _ = convenc.encode(ilv_bytes, rate, bps)       # hard symbols

    # IQ mapper (cstln_transmitter, sdr.h:1196-1221).
    pts = cstln.symbols.astype(np.float32)                  # [nsym,2]
    iq = pts[symbols]                                       # [nsym_out,2]

    # RRC interpolation (leandvbtx.cc:129-148).
    order = int(cfg.interp * cfg.rrc_rej)
    coeffs = filtergen.root_raised_cosine(order, 1.0 / cfg.interp,
                                          cfg.rolloff)
    coeffs = filtergen.normalize_power(coeffs, cfg.amp / CSTLN_AMP)
    ncoeffs = len(coeffs)
    interp = cfg.interp

    # Zero-stuff + convolve == fir_resampler's polyphase loop.
    n = iq.shape[0]
    up = np.zeros((n * interp, 2), dtype=np.float32)
    up[::interp] = iq
    y_re = np.convolve(up[:, 0], coeffs, mode="full")
    y_im = np.convolve(up[:, 1], coeffs, mode="full")
    latency = (ncoeffs + interp) // interp
    count = (n * interp - ncoeffs) // interp
    lo = latency * interp
    y = np.stack([y_re, y_im], axis=-1)[lo:lo + count * interp]
    y = y.astype(np.float32)

    # Decimation (keep 1 in d, generic.h:247-267).
    if cfg.decim > 1:
        y = y[::cfg.decim]

    if cfg.agc:
        y = simple_agc(
            y, out_rms=cfg.amp / np.sqrt(cfg.interp / cfg.decim),
            bw=0.001 * cfg.decim / cfg.interp)
    return y


class TxStream:
    """Chunked-streaming modulator with carried state.

    The reference leandvbtx is a streaming process: every stage holds its
    state in the flow graph and emits as input arrives (leandvbtx.cc:79-197).
    This class is the streaming form of `modulate`: `feed(packets)` may be
    called any number of times and the concatenation of its outputs is
    byte-identical to one batch `modulate` call on the concatenated input
    (tested in tests/test_torch_host_apps.py).

    Carried state: PRBS 8-packet phase, the interleaver's 11-packet
    backlog (dvb.h:907), the convolutional encoder's 15-bit history +
    sub-`bits_in` byte remainder (convolutional.h:241-259), the RRC
    polyphase tail of ncoeffs-1 zero-stuffed samples (dsp.h:306-337), the
    decimator phase, and the AGC one-pole power estimate + sub-128-sample
    remainder (sdr.h:237-274).
    """

    def __init__(self, cfg: TxConfig):
        self.cfg = cfg
        rate = cfg.rate
        self.cstln = make_dvbs2_constellation(cfg.constellation, rate)
        self.bps = self.cstln.bits_per_symbol
        if rate == "2/3" and self.cstln.nsymbols in (4, 64):
            rate = "4/6"
        self.rate = rate
        self.bits_in, _ = convenc.FEC_SPECS[rate]
        self.pts = self.cstln.symbols.astype(np.float32)

        order = int(cfg.interp * cfg.rrc_rej)
        coeffs = filtergen.root_raised_cosine(order, 1.0 / cfg.interp,
                                              cfg.rolloff)
        self.coeffs = filtergen.normalize_power(coeffs,
                                                cfg.amp / CSTLN_AMP)
        self.ncoeffs = len(self.coeffs)

        # Stream state.
        self._prbs_phase = 0
        self._ilv_backlog = np.empty((0, 204), np.uint8)
        self._conv_state = None          # encoder history bits
        self._conv_rem = np.empty(0, np.uint8)   # bytes < bits_in
        self._rrc_tail = np.zeros((self.ncoeffs - 1, 2), np.float32)
        # Upsampled-domain output cursor: the batch path starts emitting
        # at lo = ((ncoeffs+interp)//interp)*interp (fir_resampler's
        # priming latency); skip that many leading outputs.
        self._skip = ((self.ncoeffs + cfg.interp) // cfg.interp
                      ) * cfg.interp
        self._decim_phase = 0            # post-RRC samples consumed % decim
        self._agc_est = 0.0
        self._agc_rem = np.empty((0, 2), np.float32)

    def feed(self, packets: np.ndarray) -> np.ndarray:
        """TS packets [n,188] -> float32 IQ [m,2] emitted this chunk."""
        cfg = self.cfg
        packets = np.asarray(packets, np.uint8).reshape(-1, 188)
        randomized, self._prbs_phase = prbs.randomize(
            packets, self._prbs_phase)
        rspackets = rs.encode(randomized)
        backlog = np.concatenate([self._ilv_backlog, rspackets])
        ilv_bytes, self._ilv_backlog = interleave.interleave(backlog)

        data = np.concatenate([self._conv_rem, ilv_bytes])
        nuse = len(data) // self.bits_in * self.bits_in
        self._conv_rem = data[nuse:]
        if nuse:
            symbols, self._conv_state = convenc.encode(
                data[:nuse], self.rate, self.bps, self._conv_state)
            iq = self.pts[symbols]
        else:
            iq = np.empty((0, 2), np.float32)

        # Streaming polyphase RRC: with a tail of the last ncoeffs-1
        # zero-stuffed samples, conv(tail+new, 'valid') yields exactly
        # the next len(new) outputs of the global convolution.
        n = iq.shape[0]
        up = np.zeros((n * cfg.interp, 2), np.float32)
        if n:
            up[::cfg.interp] = iq
        x = np.concatenate([self._rrc_tail, up])
        if len(x) >= self.ncoeffs:
            y = np.stack([np.convolve(x[:, 0], self.coeffs, "valid"),
                          np.convolve(x[:, 1], self.coeffs, "valid")],
                         axis=-1).astype(np.float32)
            self._rrc_tail = x[len(x) - (self.ncoeffs - 1):]
        else:
            y = np.empty((0, 2), np.float32)
            self._rrc_tail = x if len(x) == self.ncoeffs - 1 else \
                np.concatenate([np.zeros((self.ncoeffs - 1 - len(x), 2),
                                         np.float32), x])
        if self._skip:
            drop = min(self._skip, len(y))
            y = y[drop:]
            self._skip -= drop

        if cfg.decim > 1:
            off = (-self._decim_phase) % cfg.decim
            self._decim_phase = (self._decim_phase + len(y)) % cfg.decim
            y = y[off::cfg.decim]

        if cfg.agc:
            y = np.concatenate([self._agc_rem, y])
            nfull = len(y) // 128 * 128
            self._agc_rem = y[nfull:]
            y, self._agc_est = _agc_chunks(
                y[:nfull], self._agc_est,
                out_rms=cfg.amp / np.sqrt(cfg.interp / cfg.decim),
                bw=0.001 * cfg.decim / cfg.interp)
        return np.ascontiguousarray(y, np.float32)


def _agc_chunks(x: np.ndarray, est: float, out_rms: float, bw: float):
    """simple_agc over whole 128-sample chunks with carried estimate."""
    x = x.reshape(-1, 128, 2).astype(np.float32)
    amp2 = (x[:, :, 0] ** 2 + x[:, :, 1] ** 2).sum(axis=1) / 128.0
    out = np.empty_like(x)
    for k in range(x.shape[0]):
        if not est:
            est = amp2[k]
        est = est * (1 - bw) + amp2[k] * bw
        gain = out_rms / np.sqrt(est) if est else 0.0
        out[k] = x[k] * np.float32(gain)
    return out.reshape(-1, 2), est


def simple_agc(x: np.ndarray, out_rms: float, bw: float) -> np.ndarray:
    """simple_agc (sdr.h:237-274): per-128-sample chunks, 1-pole power
    estimate, gain = out_rms/sqrt(est)."""
    n = (len(x) // 128) * 128
    x = x[:n].reshape(-1, 128, 2).astype(np.float32)
    amp2 = (x[:, :, 0] ** 2 + x[:, :, 1] ** 2).sum(axis=1) / 128.0
    out = np.empty_like(x)
    est = 0.0
    for k in range(x.shape[0]):
        if not est:
            est = amp2[k]
        est = est * (1 - bw) + amp2[k] * bw
        gain = out_rms / np.sqrt(est) if est else 0.0
        out[k] = x[k] * np.float32(gain)
    return out.reshape(-1, 2)


def power_to_amp(power_db: float) -> float:
    """--power dB -> amplitude (leandvbtx.cc:289)."""
    return float(np.exp(np.log(10) * power_db / 20))
