"""Demod kernel at one lane (csrc/demod.cu via dsp/receiver_kernel.demod,
called by DvbsReceiver.process): device ms per read, from the profiler
over the traced stretch."""
from sdrbench.metrics._common import kernel_seconds


def read(data):
    tr = data.get("trace")
    t = kernel_seconds(tr, "demod_kernel")
    if t is None:
        return None
    lo, hi = tr["units"]
    return 1e3 * t / max(hi - lo, 1)
