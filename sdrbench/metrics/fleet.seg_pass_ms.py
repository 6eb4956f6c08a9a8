"""Segmented demod's two passes (pipelines/multi_rx._demod_segmented:
the precursor windows, then the emit windows, each with its matched
filter and demod launch): host ms per chunk, from the program's
`fleet.seg.pass1` and `fleet.seg.pass2` spans over the traced stretch's
`fleet.dispatch` spans; None where the program has no such spans."""
from sdrbench.metrics._trace import inputs, record

PASSES = ("fleet.seg.pass1", "fleet.seg.pass2")


def read(data):
    rec = record()
    if rec is None:
        return None
    spans = [s for s in rec.spans if s.name in PASSES]
    n = inputs(rec, "fleet.dispatch")
    if not spans or not n:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) * 1e-6 / n
