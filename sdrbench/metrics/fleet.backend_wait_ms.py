"""Byte back end (the fleet's back-end thread): ms per chunk that a
chunk's collect job waits in the thread's queue, from when submit()
queues it to when it starts, from the program's `fleet.backend_queue`
spans over the traced stretch's `fleet.dispatch` spans."""
from sdrbench.metrics._trace import ms_per_input, record


def read(data):
    return ms_per_input(record(), "fleet.backend_queue", "fleet.dispatch")
