"""Byte back end (native/byte_backend.cc through the receiver's
backend.feed, on its own thread): host ms per chunk, mean over the
window."""
from sdrbench.metrics._common import mean


def read(data):
    return mean(data["spans"].get("backend"))
