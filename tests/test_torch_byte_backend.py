"""The port's Python fleet byte backend (pipelines/multi_rx._ByteBackend,
`native=False`) against its C++ one (native/NativeByteBackend) and
against the JAX package's `_ByteBackend`, on the same byte streams:
MPEG framing lock and unlock, polarity inversion, bit-phase shifts, RS
correction and failure, the derandomizer, and the non-fastlock resync
callback (the cases of tests/test_native_backend.py). Checkpoint blobs:
the port's own round trip, and a JAX `_ByteBackend` blob restored into
the port's.

Tolerance: none. TS packets, locks, bit and error counters, next_sync
calls and backlogs are equal.
"""

import numpy as np
import pytest
import torch

from leansdr_tpu.pipelines.multi_rx import _ByteBackend as JaxByteBackend

from leansdr_tpu_torch.fec import interleave, prbs, rs
from leansdr_tpu_torch.native import NativeByteBackend
from leansdr_tpu_torch.pipelines import tsgen
from leansdr_tpu_torch.pipelines.multi_rx import (_ByteBackend,
                                                  make_byte_backend)

# Single-threaded torch, as in every port test file.
torch.set_num_threads(1)


def make_stream(npkt, seed, nerr=0, prefix=0, invert=False, bitshift=0,
                burst=None):
    """TS -> randomize -> RS encode -> interleave byte stream, impaired
    (tests/test_native_backend.py, on the port's copies)."""
    rng = np.random.default_rng(seed)
    rnd, _ = prbs.randomize(tsgen.generate(npkt), 0)
    b = interleave.interleave(rs.encode(rnd))[0].astype(np.uint8).copy()
    if nerr:
        pos = rng.integers(0, len(b), nerr)
        b[pos] ^= rng.integers(1, 256, nerr).astype(np.uint8)
    if burst is not None:
        o, ln = burst
        b[o:o + ln] = rng.integers(0, 256, ln).astype(np.uint8)
    if prefix:
        b = np.concatenate(
            [rng.integers(0, 256, prefix).astype(np.uint8), b])
    if invert:
        b = b ^ np.uint8(0xFF)
    if bitshift:
        w = (b[:-1].astype(np.uint16) << 8) | b[1:]
        b = ((w >> (8 - bitshift)) & 0xFF).astype(np.uint8)
    return b


STREAMS = {
    "fastlock impaired": (True, 4096, lambda: [
        make_stream(300, 1),
        make_stream(200, 2, nerr=40, prefix=777),
        make_stream(200, 3, invert=True, bitshift=3),
        make_stream(200, 4, nerr=25, prefix=391, invert=True, bitshift=6)]),
    "unlock relock": (True, 3000, lambda: [
        make_stream(300, 5, burst=(30000, 5000)),
        make_stream(300, 6, burst=(40000, 12000), bitshift=1)]),
    "rs failures": (True, 4096, lambda: [
        make_stream(150, 10, nerr=400), make_stream(150, 11, nerr=600)]),
    "no fastlock, next_sync": (False, 2048, lambda: [
        np.concatenate([np.random.default_rng(7).integers(
            0, 256, 60000).astype(np.uint8), make_stream(120, 8)]),
        make_stream(120, 9, prefix=123)]),
}


def _feed_all(backends, streams, chunk):
    """Feed every backend the same chunks; per chunk, each one's output."""
    outs = [[] for _ in backends]
    for o in range(0, max(map(len, streams)), chunk):
        part = [s[o:o + chunk] for s in streams]
        for i, b in enumerate(backends):
            outs[i].append(b.feed(part))
    return outs


def _assert_outputs_equal(a, b):
    for k, (x, y) in enumerate(zip(a, b, strict=True)):
        for c, (p, q) in enumerate(zip(x, y, strict=True)):
            assert p.shape == q.shape, (k, c, p.shape, q.shape)
            assert (p == q).all(), (k, c)


@pytest.mark.parametrize("name", list(STREAMS))
def test_python_backend_matches_native_and_jax(name):
    """The port's _ByteBackend, its NativeByteBackend and the JAX
    _ByteBackend on the same chunks: equal TS, locks, counters and
    next_sync calls per channel."""
    fastlock, chunk, make = STREAMS[name]
    streams = make()
    C = len(streams)
    fires = [np.zeros(C, np.int64) for _ in range(3)]

    def cb(i):
        return lambda c: fires[i].__setitem__(c, fires[i][c] + 1)
    nxt = [None] * 3 if fastlock else [cb(i) for i in range(3)]
    py = _ByteBackend(C, fastlock, nxt[0])
    nat = NativeByteBackend(C, fastlock, nxt[1])
    jx = JaxByteBackend(C, fastlock, nxt[2])
    o_py, o_nat, o_jx = _feed_all((py, nat, jx), streams, chunk)
    _assert_outputs_equal(o_py, o_nat)
    _assert_outputs_equal(o_py, o_jx)
    total = sum(len(x[c]) for x in o_py for c in range(C))
    assert total > 100 * C // 2, total
    assert py.locks == nat.locks == jx.locks
    for k in ("vbitcount", "verrcount"):
        np.testing.assert_array_equal(getattr(py, k), getattr(nat, k))
        np.testing.assert_array_equal(getattr(py, k), getattr(jx, k))
    np.testing.assert_array_equal(fires[0], fires[1])
    np.testing.assert_array_equal(fires[0], fires[2])
    if not fastlock:
        assert fires[0][0] > 0       # the garbage prefix forced a resync


def test_python_backend_blobs():
    """Checkpoint blobs mid-stream: the port's own save_blob/restore_blob,
    and a JAX _ByteBackend blob restored into the port's; every backend
    then gives the same TS, locks, counters and backlogs on the rest of
    the stream. make_byte_backend picks Python only for native=False."""
    streams = STREAMS["fastlock impaired"][2]()
    C = len(streams)
    half = [s[:20000] for s in streams]
    rest = [s[20000:] for s in streams]
    a = _ByteBackend(C, True)
    j = JaxByteBackend(C, True)
    a.feed(half)
    j.feed(half)
    b = make_byte_backend(C, True, native=False)
    assert type(b) is _ByteBackend
    b.restore_blob(a.save_blob())
    from_jax = _ByteBackend(C, True)
    from_jax.restore_blob(j.save_blob())
    outs = _feed_all((a, b, from_jax, j), rest, 4096)
    for o in outs[1:]:
        _assert_outputs_equal(outs[0], o)
    assert sum(len(x[c]) for x in outs[0] for c in range(C)) > 0
    for x in (b, from_jax, j):
        assert x.locks == a.locks
        np.testing.assert_array_equal(x.vbitcount, a.vbitcount)
        np.testing.assert_array_equal(x.verrcount, a.verrcount)
        for c in range(C):
            np.testing.assert_array_equal(x.byte_backlog[c],
                                          a.byte_backlog[c])
            np.testing.assert_array_equal(x.mpegbyte_backlog[c],
                                          a.mpegbyte_backlog[c])
    assert type(make_byte_backend(C, True)) is NativeByteBackend
    assert type(make_byte_backend(C, True, native=True)) is \
        NativeByteBackend
