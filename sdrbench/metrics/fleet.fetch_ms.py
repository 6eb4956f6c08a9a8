"""Fetch (the fleet's fetch thread: one device-to-host copy of a chunk's
packed results, after the chunk's device work): host ms per chunk, from
the program's `fleet.fetch` spans over the traced stretch's
`fleet.dispatch` spans."""
from sdrbench.metrics._trace import ms_per_input, record


def read(data):
    return ms_per_input(record(), "fleet.fetch", "fleet.dispatch")
