"""DVB-S receiver configuration (the fields of
leansdr_tpu/pipelines/dvbs_rx.py `RxConfig`, and the TS / RS packet
sizes).

The single-carrier receiver `DvbsReceiver` is not ported yet (ROADMAP
queue 1 item 10). `exact_lut` has no "auto" here: the JAX package
resolves None from its backend, the port asks the caller to say it.
"""

from dataclasses import dataclass

from ..dsp.cstln import Predef

TS_SIZE = 188
RS_SIZE = 204


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
    # computed path of the demod kernel. Must be given explicitly.
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
