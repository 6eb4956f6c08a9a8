"""Segmented demod's handover: the share of the segment boundaries at
which no anchor symbol was found in the overlap window, so the engine
cut blind, in %, from the program's `seg.blind` and `seg.boundaries`
counters over the traced stretch; None where the program has no such
counters."""
from sdrbench.metrics._trace import record


def read(data):
    rec = record()
    if rec is None:
        return None
    bounds = rec.counters.get("seg.boundaries", 0)
    if not bounds:
        return None
    return 100.0 * rec.counters.get("seg.blind", 0) / bounds
