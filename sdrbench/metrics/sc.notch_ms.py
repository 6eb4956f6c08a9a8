"""Auto-notch (dsp/blocks_device.AutoNotch1 in DvbsReceiver._preprocess:
host blocks, device trackers, the detection FFT every 4M samples): host
ms per read, mean over the window."""
from sdrbench.metrics._common import mean


def read(data):
    return mean(data["spans"].get("notch"))
