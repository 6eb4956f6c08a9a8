"""Helpers of the readers of the program's own spans and counters (not a
metric): the record of the last stretch the program traced, which is the
stretch the traced run's profiler recorded (the program traces an input
whose entry thread records a profiler), from its tracing layer
(leansdr_tpu_torch/util/trace.py). A program without that layer gives
no record, and each reader None."""


def record():
    """The program's trace.record(), or None."""
    try:
        from leansdr_tpu_torch.util import trace
    except ImportError:
        return None
    return trace.record()


def inputs(rec, entry: str) -> int:
    """The inputs of the stretch: its spans named `entry`."""
    return sum(1 for s in rec.spans if s.name == entry)


def ms_per_input(rec, name: str, entry: str):
    """The summed ms of the spans named `name` over the stretch's inputs
    (spans `entry`); None without a record or an input."""
    if rec is None:
        return None
    n = inputs(rec, entry)
    if not n:
        return None
    return sum(s.end_ns - s.start_ns for s in rec.spans
               if s.name == name) * 1e-6 / n
