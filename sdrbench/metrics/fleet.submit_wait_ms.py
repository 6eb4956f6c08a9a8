"""Fleet entry (pipelines/multi_rx.MultiDvbsReceiver.submit): host ms per
chunk that submit() blocks on earlier chunks (back-pressure at
max_inflight, the framer's resync feedback), from the program's
`fleet.wait` spans over the traced stretch's `fleet.dispatch` spans."""
from sdrbench.metrics._trace import ms_per_input, record


def read(data):
    return ms_per_input(record(), "fleet.wait", "fleet.dispatch")
