"""Fleet entry (pipelines/multi_rx.MultiDvbsReceiver.dispatch): host ms
per chunk, mean over the window, of the call that plans the chunk's
decodes and enqueues its device work."""
from sdrbench.metrics._common import mean


def read(data):
    return mean(data["spans"].get("dispatch"))
