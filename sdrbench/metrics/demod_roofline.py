"""Demod kernel (csrc/demod.cu via dsp/receiver_kernel.demod): its
least time at the card's peaks for the lane-samples it was launched on
(sdrbench/peaks.py), over its device time in the profiler, in %."""
from sdrbench import peaks
from sdrbench.metrics._common import kernel_seconds, traced_shapes


def read(data):
    t = kernel_seconds(data.get("trace"), "demod_kernel")
    shapes = traced_shapes(data, "demod")
    if t is None or not shapes:
        return None
    return 100.0 * peaks.demod_bound_s(sum(c * n for c, n in shapes)) / t
