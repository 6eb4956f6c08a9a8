"""Generic host blocks (a copy of the parts of leansdr_tpu/core/generic.py
the single-carrier receiver uses)."""


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
