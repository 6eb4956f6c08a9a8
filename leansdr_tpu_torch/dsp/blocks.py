"""Host NumPy blocks of the single-carrier preprocessing chain (copies
of leansdr_tpu/dsp/blocks.py `decimate` and `Rotator`).

  decimate  decimator (reference generic.h:247-267)
  Rotator   rotator (reference sdr.h:1228-1261): fixed frequency shift
            through the 65536-entry trig16 table
"""

import numpy as np

from .math_utils import trig16_table


def decimate(x: np.ndarray, d: int) -> np.ndarray:
    """Keep 1 sample in d."""
    return x[::d]


class Rotator:
    """Fixed frequency shift with the 65536-entry LUT quantization:
    freq quantized to n/65536 cycles/sample, 16-bit phase index."""

    def __init__(self, freq: float):
        self.ifreq = int(freq * 65536)
        self.index = 0
        self._trig = trig16_table()

    def process(self, x: np.ndarray) -> np.ndarray:
        n = len(x)
        e = self._trig[((self.index + np.arange(n)) * self.ifreq) & 0xFFFF]
        c, s = e[:, 0], e[:, 1]
        self.index = (self.index + n) & 0xFFFF
        return ((x.real * c - x.imag * s)
                + 1j * (x.real * s + x.imag * c)).astype(np.complex64)
