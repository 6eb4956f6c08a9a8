"""Service, on the single carrier: the median latency of the same packets
as sc.latency_p95_ms, from the hand-over of the read that completed each
to the return of the call that gave it back."""
from sdrbench.metrics._common import latency_ms


def read(data):
    return latency_ms(data, 50)
