"""Auto-notch and the rest of DvbsReceiver's preprocessing (the scale,
the notch's host blocks and device trackers, the conversion back to IQ
planes): host ms per read, from the program's `rx.preprocess` spans
over the traced stretch's `rx.process` spans (sc.notch_ms sees only the
notch's process())."""
from sdrbench.metrics._trace import ms_per_input, record


def read(data):
    return ms_per_input(record(), "rx.preprocess", "rx.process")
