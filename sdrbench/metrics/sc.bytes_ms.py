"""TS stages (DvbsReceiver._byte_stages: MPEG sync, deinterleave, RS,
derandomize on the host): host ms per read, mean over the window."""
from sdrbench.metrics._common import mean


def read(data):
    return mean(data["spans"].get("bytes"))
