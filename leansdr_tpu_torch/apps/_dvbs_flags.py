"""DVB-S receiver flags of leandvb (a copy of
leansdr_tpu/apps/_dvbs_flags.py: same names, same semantics, same
code-rate validation, reference leandvb.cc:974-1221 flag set)."""

import atexit
import sys

from ..dsp.cstln import Predef
from ..util import trace

CONSTELLATIONS = {
    "BPSK": Predef.BPSK, "QPSK": Predef.QPSK, "8PSK": Predef.PSK8,
    "16APSK": Predef.APSK16, "32APSK": Predef.APSK32,
    "64APSKe": Predef.APSK64E, "16QAM": Predef.QAM16,
    "64QAM": Predef.QAM64, "256QAM": Predef.QAM256,
}

CODE_RATES = ("1/2", "2/3", "3/4", "4/6", "5/6", "7/8", "4/5")


def handle_dvbs_flag(a: str, val, cfg) -> bool:
    """Apply one shared DVB-S option to `cfg`. `val` is a callable
    returning the next argv token. Returns True if `a` was consumed."""
    if a == "--float-scale":
        cfg.float_scale = float(val())
    elif a == "-f":
        cfg.Fs = float(val())
    elif a == "--sr":
        cfg.Fm = float(val())
    elif a == "--tune":
        cfg.Ftune = float(val())
    elif a == "--drift":
        cfg.allow_drift = True
    elif a == "--const":
        cfg.constellation = CONSTELLATIONS[val()]
    elif a == "--cr":
        cfg.rate = val()
        if cfg.rate not in CODE_RATES:
            print(f"** Error while processing '{cfg.rate}'",
                  file=sys.stderr)
            sys.exit(1)
    elif a == "--sampler":
        cfg.sampler = val()
    elif a == "--rrc-steps":
        cfg.rrc_steps = int(val())
    elif a == "--rrc-rej":
        cfg.rrc_rej = float(val())
    elif a == "--roll-off":
        cfg.rolloff = float(val())
    elif a == "--exact-lut":
        cfg.exact_lut = True       # bit-exact LUT decision path
    elif a == "--no-exact-lut":
        cfg.exact_lut = False      # computed path (the demod kernel)
    elif a == "--segments":
        cfg.segments = int(val())
    elif a == "--fastlock":
        cfg.fastlock = True
    elif a == "--viterbi":
        cfg.viterbi = True
    elif a == "--hq":
        cfg.fastlock = True
        cfg.viterbi = True
        cfg.sampler = "rrc"
    elif a == "--trace":
        trace_to(val())
    else:
        return False
    return True


_trace_path = []


def trace_to(path: str):
    """--trace FILE: trace every input from now on; write_trace() (at the
    end of main, or at exit) writes the record to FILE."""
    trace.enable()
    _trace_path[:] = [path]
    atexit.register(write_trace)


def write_trace():
    """Write the --trace record as Chrome-trace JSON (once)."""
    if _trace_path:
        trace.disable()
        trace.write_chrome(_trace_path.pop())
