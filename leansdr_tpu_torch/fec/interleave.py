"""Forney convolutional interleaver I=12, M=17 (reference dvb.h:900-916;
the TX side of leansdr_tpu/fec/interleave.py, copied for the stimulus
generator; the receiver's deinterleaver runs in native/byte_backend.cc).

TX (interleaver, dvb.h:906-916): output byte i of a 204-byte packet comes
from packet `pin[11 - (i%12)]` at offset i, i.e. needs 12 packets of
lookahead.
"""

import numpy as np

RS_SIZE = 204


def interleave_indices() -> np.ndarray:
    """For TX: flat gather indices into a [12, 204] packet window."""
    i = np.arange(RS_SIZE)
    delay = i % 12
    pkt = 11 - delay
    return pkt * RS_SIZE + i


def interleave(backlog: np.ndarray):
    """Interleave a backlog of [m,204] RS packets (oldest first).

    Emits one 204-byte output per input packet while >=12 are available
    (the reference's in.readable() >= 12, dvb.h:907): output k gathers from
    packets[k .. k+11]. Returns (bytes [(m-11)*204], remaining backlog
    [11,204]) — the last 11 packets stay queued.
    """
    backlog = np.atleast_2d(np.asarray(backlog, dtype=np.uint8))
    m = backlog.shape[0]
    n = max(0, m - 11)
    if n == 0:
        return np.empty(0, np.uint8), backlog
    idx = interleave_indices()
    flat = backlog.reshape(-1)
    base = np.arange(n)[:, None] * RS_SIZE + idx[None, :]
    out = flat[base]
    return out.reshape(-1), backlog[n:]
