"""DVB-S modulator pipeline (reference leandvbtx.cc:79-197; the batch
`modulate` of leansdr_tpu/pipelines/dvbs_tx.py, copied so the port makes
its own stimulus).

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
