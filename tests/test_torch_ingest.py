"""The port's host ingest (leansdr_tpu_torch.util.ingest) against the JAX
package's (leansdr_tpu.util.ingest): DeviceFeeder's order, contents and
overlap with a slow consumer, as tests/test_ingest.py holds the JAX one
(here on the CPU, where the port yields CPU tensors in order), and
read_chunks' boundaries equal to JAX's. The pinned-buffer CUDA path runs
on the card (chip_smoke.py's multi path checks every chunk's contents).
"""

import io
import time

import numpy as np
import pytest
import torch

from leansdr_tpu.util import ingest as ji
from leansdr_tpu_torch.util.ingest import DeviceFeeder, read_chunks

torch.set_num_threads(1)


def test_device_feeder_order_and_contents_match_jax():
    rng = np.random.default_rng(20)
    chunks = [rng.standard_normal((k + 1, 3)).astype(np.float32)
              for k in range(20)] + [np.arange(7, dtype=np.int16)]
    want = [np.asarray(a) for a in ji.DeviceFeeder(chunks, depth=3)]
    got = list(DeviceFeeder(chunks, device="cpu", depth=3))
    assert len(got) == len(want) == 21
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


def test_device_feeder_copies_the_chunk():
    """A chunk the producer later reuses: each item keeps its own
    contents (as jax.device_put's copy does)."""
    buf = np.zeros(16, np.float32)

    def source():
        for k in range(6):
            buf[:] = k
            yield buf
            time.sleep(0.005)
    seen = [int(t[0]) for t in DeviceFeeder(source(), device="cpu",
                                            depth=2)]
    assert seen == list(range(6))


def test_device_feeder_overlaps_consumer():
    """A slow consumer sees every chunk once, the producer runs ahead by
    `depth` chunks while it waits, and the thread ends."""
    made = []

    def source():
        for k in range(10):
            made.append(k)
            yield np.full((8,), k, np.int32)
    fd = DeviceFeeder(source(), device="cpu", depth=2)
    seen, ahead = [], []
    for d in fd:
        time.sleep(0.02)
        ahead.append(len(made) - len(seen))
        seen.append(int(d[0]))
    assert seen == list(range(10))
    assert max(ahead) >= 2            # staged while the consumer slept
    fd._thread.join(timeout=5)
    assert not fd._thread.is_alive()


def test_device_feeder_raises_the_source_error():
    def source():
        yield np.zeros(4, np.float32)
        raise OSError("read failed")
    it = iter(DeviceFeeder(source(), device="cpu"))
    assert next(it).shape == (4,)
    with pytest.raises(OSError, match="read failed"):
        next(it)


def test_device_feeder_defaults_to_cuda():
    if torch.cuda.is_available():
        assert DeviceFeeder([]).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceFeeder([np.zeros(4, np.float32)])
    with pytest.raises(ValueError, match="depth"):
        DeviceFeeder([], device="cpu", depth=0)


@pytest.mark.parametrize("size,nbytes", [(250, 100), (0, 10), (64, 64),
                                         (1000, 7)])
def test_read_chunks_boundaries_match_jax(size, nbytes):
    data = bytes(np.random.default_rng(size).integers(
        0, 256, size, dtype=np.uint8))
    got = list(read_chunks(io.BytesIO(data), nbytes))
    want = list(ji.read_chunks(io.BytesIO(data), nbytes))
    assert [len(p) for p in got] == [len(p) for p in want]
    assert got == want and b"".join(got) == data
