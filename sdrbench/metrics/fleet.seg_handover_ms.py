"""Segmented demod's handover (pipelines/multi_rx._demod_segmented after
its two passes: the rotation estimate, the cuts, the derotation of the
persisted phases and the splice): host ms per chunk, from the program's
`fleet.seg.handover` spans over the traced stretch's `fleet.dispatch`
spans; None where the program has no such spans."""
from sdrbench.metrics._trace import inputs, record


def read(data):
    rec = record()
    if rec is None:
        return None
    spans = [s for s in rec.spans if s.name == "fleet.seg.handover"]
    n = inputs(rec, "fleet.dispatch")
    if not spans or not n:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) * 1e-6 / n
