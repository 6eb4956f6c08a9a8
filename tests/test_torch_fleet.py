"""The port's fleet receiver (leansdr_tpu_torch.pipelines.multi_rx) against
the JAX fleet receiver with its Pallas kernels in interpret mode, on the
same 2-channel stimulus, in the configuration bench.py measures
(QPSK rate 1/2, Viterbi, computed demod, RRC matched filter) at
chunk_samples=4096.

Tolerance: none. The packed fetch buffer of every chunk (decoded bytes,
election discriminants, underflow flags, ring fill) and the TS packets
must be byte-equal.

The stimulus is the modulator's output delayed by a fraction of a
sample (a different one per channel), as any received carrier is. With
the symbol instants exactly on the sample grid, the timing loop's mu
settles at the emit threshold, and which of two equivalent samples
emits a symbol is decided by the last ulp of mu, where XLA and PyTorch
round differently (XLA contracts multiply-adds and has its own cos/sin).
"""

import numpy as np
import pytest
import torch

import jax

from leansdr_tpu.pipelines import tsgen, dvbs_tx
from leansdr_tpu.pipelines.dvbs_rx import RxConfig as JaxRxConfig
from leansdr_tpu.pipelines.multi_rx import MultiDvbsReceiver as JaxRx

from leansdr_tpu_torch.convert import from_jax_checkpoint
from leansdr_tpu_torch.pipelines.dvbs_rx import RxConfig
from leansdr_tpu_torch.pipelines.multi_rx import MultiDvbsReceiver

C = 2
CHUNK = 4096
NPKT = 36
DELAYS = (0.3, 0.6)
CFG = dict(Fs=4e6, Fm=2e6, rate="1/2", fastlock=True, float_scale=75,
           exact_lut=False, viterbi=True, sampler="rrc")


@pytest.fixture(scope="module")
def frames():
    iqs = []
    for c, d in enumerate(DELAYS):
        q = dvbs_tx.modulate(tsgen.generate(NPKT, start=500 * c),
                             dvbs_tx.TxConfig(rate="1/2", interp=2))
        iqs.append((1 - d) * q[:-1] + d * q[1:])
    n = min(map(len, iqs))
    return np.stack([q[:n] for q in iqs]).astype(np.float32)


def _receivers():
    jax.clear_caches()
    j = JaxRx(JaxRxConfig(**CFG), C, use_pallas=True, chunk_samples=CHUNK)
    t = MultiDvbsReceiver(RxConfig(**CFG), C, chunk_samples=CHUNK,
                          device="cpu")
    return j, t


def _step_both(j, t, blk, k):
    """Dispatch one chunk into both, compare the packed buffers, collect.
    Returns (jax TS packets, port TS packets) per channel."""
    pj, pt = j.dispatch(blk), t.dispatch(blk)
    assert (pj is None) == (pt is None), f"chunk {k}: dispatch differs"
    if pj is None:
        return None, None
    bj, bt = np.asarray(pj[0]), pt[0].numpy()
    assert bj.shape == bt.shape, f"chunk {k}: {bj.shape} != {bt.shape}"
    bad = np.argwhere(bj != bt)
    assert not len(bad), (
        f"chunk {k}: {len(bad)} bytes differ; first at channel "
        f"{bad[0][0]} byte {bad[0][1]}: jax {bj[tuple(bad[0])]} "
        f"port {bt[tuple(bad[0])]}")
    assert pj[1] == pt[1], f"chunk {k}: decode shapes differ"
    return j.collect(pj), t.collect(pt)


def test_fleet_cold_start_matches_jax(frames):
    """5 chunks from cold: ACQUIRE, the sync election, the switch to
    TRACK; the packed fetch buffers are byte-equal chunk by chunk."""
    j, t = _receivers()
    for k in range(5):
        _step_both(j, t, frames[:, k * CHUNK:(k + 1) * CHUNK], k)
    assert j.deconv.track and t.deconv.track
    np.testing.assert_array_equal(np.asarray(j.deconv.state["current"]),
                                  t.deconv.state["current"].numpy())


def test_convert_scan_path_checkpoint(frames):
    """A checkpoint of the JAX receiver's scan demod path (use_pallas=
    False: state as a dict of [C] arrays) converts to the same [19, C]
    planes the Pallas layout would hold, with the trellis planes
    stripped of their lane padding."""
    from leansdr_tpu.dsp import receiver_pallas as rp
    jax.clear_caches()
    j = JaxRx(JaxRxConfig(**CFG), C, use_pallas=False, chunk_samples=CHUNK)
    j.collect(j.dispatch(frames[:, :CHUNK]))
    t = MultiDvbsReceiver(RxConfig(**CFG), C, chunk_samples=CHUNK,
                          device="cpu")
    t.load_state(from_jax_checkpoint(j.save_state()))
    want = np.asarray(rp.pack_state(j.state)).reshape(19, -1)[:, :C]
    np.testing.assert_array_equal(t._planes.numpy(), want)
    for k in ("buf", "cost", "fill", "current"):
        np.testing.assert_array_equal(t.deconv.state[k].numpy(),
                                      np.asarray(j.deconv.state[k]))
    assert t.deconv.state["metric"].shape == (64, C * 4)
    assert t.deconv.track == j.deconv.track
    assert t._chunk_count == 1


def test_port_checkpoint_and_pipelined_streaming(frames):
    """The port's own save_state/load_state round trip, and the
    pipelined submit/flush path (fetch and byte backend on threads) give
    the same packed bytes and TS output as sequential process()."""
    cfg = RxConfig(**CFG)
    a = MultiDvbsReceiver(cfg, C, chunk_samples=CHUNK, device="cpu")
    blk = [frames[:, k * CHUNK:(k + 1) * CHUNK] for k in range(4)]
    a.process(blk[0])
    a.process(blk[1])
    b = MultiDvbsReceiver(cfg, C, chunk_samples=CHUNK, device="cpu")
    b.load_state(a.save_state())
    pa = a.dispatch(blk[2])
    pb = b.prefetch(b.dispatch(blk[2]))
    assert torch.equal(pa[0], torch.from_numpy(pb[0].result()))
    assert [len(o) for o in a.collect(pa)] == \
        [len(o) for o in b.collect(pb)]
    seq = a.process(blk[3])
    done = b.submit(blk[3]) + b.flush()
    b.close()
    assert len(done) == 1
    for x, y in zip(seq, done[0]):
        np.testing.assert_array_equal(x, y)
    m = b.metrics()
    assert all(v.shape == (C,) and np.isfinite(v).all() for v in m.values())


def test_fleet_warm_start_from_jax_checkpoint(frames):
    """JAX runs 14 chunks alone; its checkpoint is carried into the port
    (convert.from_jax_checkpoint) and both run 4 more chunks: equal
    packed buffers and TS packets, and the packets are ones that were
    sent (from the derandomizer's first sync on: before it, the PRBS
    phase is unknown and the payloads are scrambled, in both)."""
    j, _ = _receivers()
    warm = 14
    for k in range(warm):
        pend = j.dispatch(frames[:, k * CHUNK:(k + 1) * CHUNK])
        if pend is not None:
            j.collect(pend)
    assert all(j.locks)
    t = MultiDvbsReceiver(RxConfig(**CFG), C, chunk_samples=CHUNK,
                          device="cpu")
    t.load_state(from_jax_checkpoint(j.save_state()))
    got_j = [[] for _ in range(C)]
    got_t = [[] for _ in range(C)]
    for k in range(warm, warm + 4):
        oj, ot = _step_both(j, t, frames[:, k * CHUNK:(k + 1) * CHUNK], k)
        for c in range(C):
            got_j[c] += list(oj[c])
            got_t[c] += list(ot[c])
    assert t.locks == j.locks
    for c in range(C):
        a, b = np.array(got_j[c]), np.array(got_t[c])
        assert a.shape == b.shape and (a == b).all(), f"channel {c}"
        sent = tsgen.generate(NPKT, start=500 * c)
        hits = [int(np.nonzero((sent == p).all(axis=1))[0][0])
                if (sent == p).all(axis=1).any() else -1 for p in b]
        first = next(i for i, h in enumerate(hits) if h >= 0)
        good = hits[first:]
        assert len(good) >= 3 and good == list(range(good[0],
                                                      good[0] + len(good))), \
            f"channel {c}: packet indices {hits}"


def test_fleet_allow_drift_clamps_like_jax():
    """RxConfig(allow_drift=True), the flag `--drift` sets: the JAX fleet
    builds its demod without it, so freqw is clamped back to the middle
    of [min_freqw, max_freqw] whenever the carrier loop leaves that
    range; the port's fleet must do the same. The stimulus is a carrier
    whose frequency ramps at 0.2 freqw units per sample from sample 1024
    on, which the loop tracks past max_freqw (4096 here) in chunk 5.
    Packed buffers are byte-equal chunk by chunk."""
    cfg = dict(CFG, allow_drift=True)
    iqs = []
    for c, d in enumerate(DELAYS):
        q = dvbs_tx.modulate(tsgen.generate(24, start=500 * c),
                             dvbs_tx.TxConfig(rate="1/2", interp=2))
        q = (1 - d) * q[:-1] + d * q[1:]
        n = np.maximum(np.arange(len(q), dtype=np.float64) - 1024, 0)
        z = (q[:, 0] + 1j * q[:, 1]) * np.exp(1j * np.pi * 0.2 / 65536
                                              * n * n)
        iqs.append(np.stack([z.real, z.imag], -1))
    n = min(map(len, iqs))
    frames = np.stack([q[:n] for q in iqs]).astype(np.float32)
    jax.clear_caches()
    j = JaxRx(JaxRxConfig(**cfg), C, use_pallas=True, chunk_samples=CHUNK)
    t = MultiDvbsReceiver(RxConfig(**cfg), C, chunk_samples=CHUNK,
                          device="cpu")
    lo, hi = t.params.freq_limits
    freqw = []
    for k in range(7):
        _step_both(j, t, frames[:, k * CHUNK:(k + 1) * CHUNK], k)
        freqw.append(t._planes[2].numpy().copy())
    freqw = np.array(freqw)                               # [chunk, C]
    # The loop came near the limit, then was put back to the middle.
    assert (freqw[:6].max(axis=0) > 0.9 * hi).all(), freqw
    assert (np.abs(freqw[-1] - (lo + hi) / 2) < 0.5 * hi).all(), freqw
