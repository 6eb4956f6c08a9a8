"""Rate-1/2 ACS kernel (csrc/acs.cu): its least time at the card's peaks
(bytes over HBM, integer operations over the INT32 issue rate the run's
SM count and clock give; sdrbench/peaks.py) for the trellis steps it was
launched on, over its device time in the profiler, in %."""
from sdrbench import peaks
from sdrbench.metrics._common import kernel_seconds, traced_shapes


def read(data):
    t = kernel_seconds(data.get("trace"), "acs_kernel")
    shapes = traced_shapes(data, "acs")
    rate = peaks.int32_ops_per_s(data.get("card") or {})
    if t is None or not shapes or not rate:
        return None
    return 100.0 * peaks.acs_bound_s(sum(T * N for T, N in shapes), rate) / t
