"""Decoder: the share of the traced stretch's decodes that ran in TRACK
(the elected sync replica alone) rather than ACQUIRE (every replica),
from the program's `fleet.decodes.track` and `fleet.decodes.acquire`
counters, in %."""
from sdrbench.metrics._trace import record


def read(data):
    rec = record()
    if rec is None:
        return None
    track = rec.counters.get("fleet.decodes.track", 0)
    total = track + rec.counters.get("fleet.decodes.acquire", 0)
    return 100.0 * track / total if total else None
