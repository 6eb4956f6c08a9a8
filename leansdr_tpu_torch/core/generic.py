"""Generic host blocks (reference generic.h; a NumPy copy of
leansdr_tpu/core/generic.py): ItemCounter, decimate, serialize and the
VBER RateEstimator."""

import numpy as np


class ItemCounter:
    """itemcounter (generic.h:227-243): emits the number of items that
    passed through (drives the TS-rate display)."""

    def __init__(self):
        self.count = 0

    def process(self, items) -> int:
        self.count += len(items)
        return self.count


def decimate(x: np.ndarray, d: int) -> np.ndarray:
    """decimator<T> (generic.h:247-267): keep 1 item in d."""
    return x[::d]


def serialize(x: np.ndarray, dtype) -> np.ndarray:
    """serializer (generic.h:310-331): reinterpret between item sizes."""
    return np.frombuffer(np.ascontiguousarray(x).tobytes(), dtype=dtype)


class RateEstimator:
    """rate_estimator (reference generic.h:272-305): accumulates numerator
    and denominator counts and emits their ratio once `sample_size`
    denominator units have been seen (the VBER estimator, window >= 50000
    bits, leandvb.cc:585-587)."""

    def __init__(self, sample_size: int = 50000):
        self.sample_size = sample_size
        self.num = 0
        self.den = 0
        self.estimates = []

    def update(self, num: int, den: int):
        self.num += num
        self.den += den
        if self.den >= self.sample_size:
            self.estimates.append(self.num / self.den)
            self.num = 0
            self.den = 0

    @property
    def latest(self):
        return self.estimates[-1] if self.estimates else None
