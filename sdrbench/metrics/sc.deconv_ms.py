"""Hard decisions (pipelines/dvbs_rx._DeconvolSync.process, NumPy on the
host): host ms per read, mean over the window."""
from sdrbench.metrics._common import mean


def read(data):
    return mean(data["spans"].get("deconv"))
