"""Device, in the fleet: the share of the traced steady stretch in which
no operation ran on the card, in %."""
from sdrbench.metrics._common import idle_pct


def read(data):
    return idle_pct(data)
