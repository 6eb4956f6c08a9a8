"""Decoder (fec/viterbi_device.viterbi_decode called in the fleet's
dispatch): host ms per chunk spent enqueuing the chunk's decodes, waits
on the card included, from the program's `fleet.decode` spans over the
traced stretch's `fleet.dispatch` spans."""
from sdrbench.metrics._trace import ms_per_input, record


def read(data):
    return ms_per_input(record(), "fleet.decode", "fleet.dispatch")
