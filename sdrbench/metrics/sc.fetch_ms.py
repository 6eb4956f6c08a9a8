"""Demod kernel, seen from the host: ms per read that DvbsReceiver.process
blocks on the copy of the demod's output to the host (the kernel's run
and the copy), from the program's `rx.fetch` spans over the traced
stretch's `rx.process` spans."""
from sdrbench.metrics._trace import ms_per_input, record


def read(data):
    return ms_per_input(record(), "rx.fetch", "rx.process")
