"""The port's fleet receiver at the punctured rate 3/4 (banked ACS)
against the JAX fleet receiver, on the same 2-channel stimulus, at
chunk_samples=4096: cold start through the switch to TRACK, and
checkpoints of the JAX receiver in both of its punctured trellis layouts
carried into the port, which continues byte-equal and decodes the TS
packets that were sent.

The JAX receiver runs its Pallas demod in interpret mode; for the cold
start its Viterbi is swapped to the banked Pallas kernel in interpret
mode (on the CPU it defaults to the XLA-scan path, whose checkpoint
layout the second test converts).

Tolerance: none. The packed fetch buffer of every chunk (decoded bytes,
election discriminants, underflow flags, ring fill) and the TS packets
must be byte-equal. The stimulus is delayed by a fraction of a sample
per channel (see tests/test_torch_fleet.py for why).
"""

import numpy as np
import pytest
import jax

from leansdr_tpu.pipelines import tsgen, dvbs_tx
from leansdr_tpu.pipelines.dvbs_rx import RxConfig as JaxRxConfig
from leansdr_tpu.pipelines.multi_rx import MultiDvbsReceiver as JaxRx

from leansdr_tpu_torch.convert import from_jax_checkpoint
from leansdr_tpu_torch.pipelines.dvbs_rx import RxConfig
from leansdr_tpu_torch.pipelines.multi_rx import MultiDvbsReceiver

RATE = "3/4"
C = 2
CHUNK = 4096
NPKT = 36
DELAYS = (0.3, 0.6)
CFG = dict(Fs=4e6, Fm=2e6, rate=RATE, fastlock=True, float_scale=75,
           exact_lut=False, viterbi=True, sampler="rrc")


@pytest.fixture(scope="module")
def frames():
    iqs = []
    for c, d in enumerate(DELAYS):
        q = dvbs_tx.modulate(tsgen.generate(NPKT, start=500 * c),
                             dvbs_tx.TxConfig(rate=RATE, interp=2))
        iqs.append((1 - d) * q[:-1] + d * q[1:])
    n = min(map(len, iqs))
    return np.stack([q[:n] for q in iqs]).astype(np.float32)


def _port():
    return MultiDvbsReceiver(RxConfig(**CFG), C, chunk_samples=CHUNK,
                             device="cpu")


def _jax(banked: bool):
    jax.clear_caches()
    j = JaxRx(JaxRxConfig(**CFG), C, use_pallas=True, chunk_samples=CHUNK)
    if banked:
        j.deconv = type(j.deconv)(j.cstln, j.rate, C, CHUNK, j.omega,
                                  banked=True, interpret=True)
    assert j.deconv.kind == ("viterbi_banked" if banked else "viterbi_xla")
    return j


def _step(a, b, blk, k):
    """Dispatch one chunk into receivers a and b (either may be the JAX
    one), compare the packed buffers byte for byte, collect both.
    Returns their TS packets per channel."""
    pa, pb = a.dispatch(blk), b.dispatch(blk)
    assert (pa is None) == (pb is None), f"chunk {k}: dispatch differs"
    if pa is None:
        return [[]] * C, [[]] * C
    ba, bb = np.asarray(pa[0]), np.asarray(pb[0])
    assert ba.shape == bb.shape, f"chunk {k}: {ba.shape} != {bb.shape}"
    bad = np.argwhere(ba != bb)
    assert not len(bad), (
        f"chunk {k}: {len(bad)} bytes differ; first at channel "
        f"{bad[0][0]} byte {bad[0][1]}: {ba[tuple(bad[0])]} != "
        f"{bb[tuple(bad[0])]}")
    assert pa[1] == pb[1], f"chunk {k}: decode shapes differ"
    return a.collect(pa), b.collect(pb)


def _assert_sent(c, pkts):
    """Every packet is one that was sent, in order (from the
    derandomizer's first sync on: before it the payloads are
    scrambled)."""
    sent = tsgen.generate(NPKT, start=500 * c)
    hits = [int(np.nonzero((sent == p).all(axis=1))[0][0])
            if (sent == p).all(axis=1).any() else -1 for p in pkts]
    first = next(i for i, h in enumerate(hits) if h >= 0)
    good = hits[first:]
    assert good == list(range(good[0], good[0] + len(good))), \
        f"channel {c}: packet indices {hits}"
    return len(good)


def test_fleet_3_4_cold_start_track_and_banked_checkpoint(frames):
    """6 chunks from cold, port and JAX (banked kernel) side by side:
    ACQUIRE over 8 replicas, the election, the switch to TRACK and a
    TRACK decode, byte-equal chunk by chunk. Then the JAX receiver's
    checkpoint (TPU banked layout, in TRACK) is converted into a fresh
    port receiver, which continues byte-equal to the JAX one."""
    j, t = _jax(banked=True), _port()
    assert t.deconv.kind == "viterbi_banked" and t.rate == RATE
    for k in range(6):
        _step(j, t, frames[:, k * CHUNK:(k + 1) * CHUNK], k)
        if k == 4:
            assert t.deconv.track and j.deconv.track
    assert t.locks == j.locks
    np.testing.assert_array_equal(np.asarray(j.deconv.state["tsync"]),
                                  t.deconv.state["tsync"].numpy())

    t2 = _port()
    t2.load_state(from_jax_checkpoint(j.save_state(), rate=RATE))
    assert t2.deconv.track and t2.deconv.state["metric"].shape == (64, C)
    _step(j, t2, frames[:, 6 * CHUNK:7 * CHUNK], 6)


def test_fleet_3_4_from_jax_xla_checkpoint_decodes_ts(frames):
    """The JAX receiver on its CPU XLA-scan Viterbi (trellis planes
    [C*8, 64] u32 in natural state order) runs 10 chunks alone, to lock;
    its checkpoint, converted (transposed, permuted to stored rows, cast
    to i32), lets the port continue byte-equal for 2 more chunks, and
    the TS packets both put out are ones that were sent, in order."""
    j = _jax(banked=False)
    for k in range(10):
        pend = j.dispatch(frames[:, k * CHUNK:(k + 1) * CHUNK])
        if pend is not None:
            j.collect(pend)
    assert j.deconv.state["path_hi"].shape == (C * 8, 64)
    with pytest.raises(ValueError, match="rate"):
        from_jax_checkpoint(j.save_state())
    assert all(j.locks)
    t = _port()
    t.load_state(from_jax_checkpoint(j.save_state(), rate=RATE))
    assert t.deconv.state["metric"].shape == (64, C * 8)
    got = [[] for _ in range(C)]
    for k in range(10, 12):
        oj, ot = _step(j, t, frames[:, k * CHUNK:(k + 1) * CHUNK], k)
        for c in range(C):
            np.testing.assert_array_equal(np.array(oj[c]).reshape(-1, 188),
                                          np.array(ot[c]).reshape(-1, 188))
            got[c] += list(ot[c])
    assert t.locks == j.locks and not t.deconv.track
    assert all(_assert_sent(c, got[c]) >= 2 for c in range(C))


def test_rate_2_3_runs_as_4_6():
    """Rate 2/3 builds the fleet of the JAX receiver: the "4/6" trellis
    (two 2/3 periods per block, so 3 symbol shifts and 12 replicas) on
    the banked decoder."""
    t = MultiDvbsReceiver(RxConfig(**(CFG | dict(rate="2/3"))), C,
                          chunk_samples=CHUNK, device="cpu")
    j = JaxRx(JaxRxConfig(**(CFG | dict(rate="2/3"))), C, use_pallas=True,
              chunk_samples=CHUNK)
    assert t.rate == j.rate == "4/6" and t.deconv.kind == "viterbi_banked"
    assert (t.deconv.plan.nshifts, t.deconv.plan.nsyncs, t.deconv.plan.E) \
        == (j.deconv.plan.nshifts, j.deconv.plan.nsyncs, j.deconv.plan.E) \
        == (3, 12, 1)
    assert t.deconv.maps == j.deconv.maps
