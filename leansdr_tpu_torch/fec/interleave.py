"""Forney convolutional interleaver I=12, M=17 (reference dvb.h:900-948;
a copy of leansdr_tpu/fec/interleave.py: the TX side for the stimulus
generator, the RX side for the single-carrier receiver; the fleet's
deinterleaver runs in native/byte_backend.cc).

TX (interleaver, dvb.h:906-916): output byte i of a 204-byte packet comes
from packet `pin[11 - (i%12)]` at offset i, i.e. needs 12 packets of
lookahead.

RX (deinterleaver, dvb.h:933-943): with a window of 17*11*12+204 = 2448
bytes, output byte i (of the packet starting at window offset 17*11*12)
is `window[17*11*12 + i - delay_i*12]` where delay_i cycles
17*11, 17*10, ..., 0 with period 12.
"""

import numpy as np

RS_SIZE = 204
DEPTH = 17 * 11 * 12          # 2244 bytes of history before current packet


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


def deinterleave_indices() -> np.ndarray:
    """For RX: indices into a 2448-byte window for one output packet."""
    i = np.arange(RS_SIZE)
    delay = (17 * 11 - 17 * (i % 12)) % (17 * 12)
    return DEPTH + i - delay * 12


def deinterleave(stream: np.ndarray):
    """Deinterleave as many packets as the stream allows.

    `stream` is a 1-D byte backlog; each output packet consumes 204 bytes
    and needs DEPTH + 204 bytes available. Returns ([n,204] packets,
    remaining stream).
    """
    stream = np.asarray(stream, dtype=np.uint8)
    n = max(0, (len(stream) - DEPTH) // RS_SIZE)
    if n == 0:
        return np.empty((0, RS_SIZE), np.uint8), stream
    idx = deinterleave_indices()
    base = np.arange(n)[:, None] * RS_SIZE + idx[None, :]
    out = stream[base]
    return out, stream[n * RS_SIZE:]
