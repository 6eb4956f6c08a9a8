"""DVB-S energy-dispersal PRBS randomizer (the TX-side NumPy parts of
leansdr_tpu/fec/prbs.py, copied for the stimulus generator; the
receiver's derandomizer runs in native/byte_backend.cc).

Mirrors randomizer (reference dvb.h:1063-1128): the EN 300 421 section
4.4.1 PRBS 1+x^14+x^15 seeded 000251, precomputed as a 188*8-byte
pattern with the sync-byte inversion/inhibition rules.
"""

from functools import lru_cache

import numpy as np

@lru_cache(maxsize=None)
def prbs_pattern() -> np.ndarray:
    """The 188*8-byte pattern (dvb.h:1072-1085).

    pattern[0] = 0xff (sync inversion); PRBS bytes elsewhere, zeroed on the
    7 other sync-byte positions (inhibited but still clocked).
    """
    pat = np.zeros(188 * 8, dtype=np.uint8)
    pat[0] = 0xFF
    st = 0o000251
    for i in range(1, 188 * 8):
        out = 0
        for _ in range(8):
            bit = ((st >> 13) ^ (st >> 14)) & 1
            out = ((out << 1) | bit) & 0xFF
            st = ((st << 1) | bit) & 0xFFFF
        pat[i] = out if (i % 188) else 0
    return pat


def randomize(packets: np.ndarray, start_phase: int = 0):
    """TX randomizer over a [n, 188] u8 array starting at 8-packet phase
    `start_phase`. Returns (out, next_phase)."""
    n = packets.shape[0]
    pat = prbs_pattern().reshape(8, 188)
    phases = (start_phase + np.arange(n)) % 8
    out = packets ^ pat[phases]
    return out, int((start_phase + n) % 8)
