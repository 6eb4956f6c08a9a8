"""The single-carrier receiver's back half against the JAX package, fed
symbol streams directly (no demod): the hard-decision path
(`_DeconvolSync` -> `MpegSync` -> deinterleave -> RS -> derandomize, all
host NumPy in both packages) and the soft path `ViterbiSyncDevice`, which
the port runs on the fleet's ACS kernels (their plain versions here)
where the JAX package runs an XLA scan (`_viterbi_chunk_device`).

Stimulus: the TX chain's hard symbols (randomize -> RS -> interleave ->
convolutional encode) for numbered TS packets, with symbol errors
injected, a constellation rotation and a one-symbol slip, so sync
election, MPEG unlock/relock and RS correction all run.

Tolerance: none. Decoded bytes, TS packets, vbitcount, verrcount, lock
events, locktime, the decoder's elections and, for the Viterbi decoder,
every chunk's us and q and the carried trellis state are integers and
must be equal.
"""

import numpy as np
import pytest
import torch

from leansdr_tpu.dsp.cstln import Predef, make_dvbs2_constellation
from leansdr_tpu.fec import convenc, interleave, prbs, rs
from leansdr_tpu.fec import viterbi as jvit
from leansdr_tpu.pipelines import dvbs_rx as jrx
from leansdr_tpu.pipelines import tsgen

from leansdr_tpu_torch.fec import viterbi_banked as tvb
from leansdr_tpu_torch.fec import viterbi_device as tvd
from leansdr_tpu_torch.pipelines import dvbs_rx as trx

# Single-threaded torch: the plain versions run many small ops, which
# OpenMP threads only slow down, most of all beside other test workers.
torch.set_num_threads(1)

ROT90 = np.array([2, 0, 3, 1], np.uint8)     # QPSK symbol index, +90 deg


def _tx_symbols(rate, npkt, seed, p_err=0.004, slip_at=None, rot=0):
    """Hard QPSK symbols of npkt numbered packets at `rate` (2/3 as 4/6),
    with a fraction p_err of random symbol errors, one symbol dropped at
    slip_at, rotated by rot x 90 degrees. Also soft costs: -(20..60) on
    clean symbols, -(0..10) on the corrupted ones."""
    rng = np.random.default_rng(seed)
    r = "4/6" if rate == "2/3" else rate
    rnd, _ = prbs.randomize(tsgen.generate(npkt, start=seed * 1000), 0)
    ilv, _ = interleave.interleave(rs.encode(rnd))
    bits_in = convenc.FEC_SPECS[r][0]
    sym, _ = convenc.encode(ilv[: len(ilv) // bits_in * bits_in], r, 2)
    sym = sym.astype(np.uint8)
    bad = rng.random(len(sym)) < p_err
    sym[bad] ^= rng.integers(1, 4, bad.sum()).astype(np.uint8)
    cost = np.where(bad, -rng.integers(0, 10, len(sym)),
                    -rng.integers(20, 60, len(sym))).astype(np.int16)
    for _ in range(rot):
        sym = ROT90[sym]
    if slip_at is not None:
        sym = np.delete(sym, slip_at)
        cost = np.delete(cost, slip_at)
    return sym, cost


def _receivers(rate, **kw):
    cfg = dict(rate=rate, exact_lut=False, **kw)
    j = jrx.DvbsReceiver(jrx.RxConfig(use_pallas=True, **cfg))
    t = trx.DvbsReceiver(trx.RxConfig(**cfg), device="cpu")
    return j, t


def _feed(rx, sym, cost, piece, soft):
    out = []
    for a in range(0, len(sym), piece):
        args = (sym[a:a + piece], cost[a:a + piece]) if soft else (
            sym[a:a + piece],)
        out.append(rx._byte_stages(rx.deconv.process(*args)))
        out[-1] = (out[-1], list(rx.mpeg.lock_events))
        rx.mpeg.lock_events.clear()
    return out


def _check_same(j, t, out_j, out_t):
    for k, ((pj, ej), (pt, et)) in enumerate(zip(out_j, out_t)):
        np.testing.assert_array_equal(pj, pt, err_msg=f"TS, piece {k}")
        assert ej == et, f"lock events, piece {k}"
    for name in ("vbitcount", "verrcount", "derand_pos"):
        assert getattr(j, name) == getattr(t, name), name
    for name in ("byte_backlog", "mpegbyte_backlog"):
        np.testing.assert_array_equal(getattr(j, name), getattr(t, name))
    assert j.locktime == t.locktime and j.lock == t.lock
    assert j.mpeg.locktime_count == t.mpeg.locktime_count
    assert j.vber == t.vber
    assert j.stats() == t.stats()


@pytest.mark.parametrize("rate,fastlock,rot,p_err", [("1/2", False, 0, 4e-3),
                                                     ("3/4", True, 1, 4e-3),
                                                     ("2/3", True, 3, 2e-3),
                                                     ("7/8", True, 0, 3e-4)])
def test_hard_decision_back_half_matches_jax(rate, fastlock, rot, p_err):
    """_DeconvolSync -> TS over 150 packets in uneven pieces: TS
    byte-equal, counters and lock events equal (the slip costs a resync,
    slow without fastlock). The algebraic decoder multiplies channel
    errors by its polynomials' weight, which grows with the rate, hence
    fewer injected errors at 7/8."""
    sym, cost = _tx_symbols(rate, 150, seed=3, p_err=p_err, slip_at=60000,
                            rot=rot)
    j, t = _receivers(rate, fastlock=fastlock)
    out_j = _feed(j, sym, cost, 7001, soft=False)
    out_t = _feed(t, sym, cost, 7001, soft=False)
    _check_same(j, t, out_j, out_t)
    assert j.deconv.locked == t.deconv.locked
    ts = np.concatenate([o for o, _ in out_t])
    assert len(ts) >= 20 and t.verrcount > 0
    assert any(1 in ev for _, ev in out_t)


def _state_pairs(j, t, rate):
    """JAX _dev_state ([S, 64] natural, u32 paths) in the port's layout."""
    cst, hi, lo = (np.asarray(a) for a in j.deconv._dev_state)
    if rate == "1/2":
        want = (cst.T, lo.view(np.int32).T)
    else:
        orig = tvb.bank_geometry(rate).orig
        want = tuple(a.view(np.int32).T[orig] for a in (cst, hi, lo))
    return zip(t.deconv.plane_keys, want,
               (p.numpy() for p in t.deconv._dev_state))


@pytest.mark.parametrize("rate,npkt,fastlock", [("1/2", 14, True),
                                               ("3/4", 30, True),
                                               ("7/8", 120, False)])
def test_viterbi_sync_device_matches_jax(rate, npkt, fastlock, monkeypatch):
    """ViterbiSyncDevice on the plain ACS versions (rate 1/2: acs, 3/4 and
    7/8: the banked ACS over 8 and 16 replicas) against JAX's on its XLA
    scan: every chunk's us and q for all replicas, the elected sync, the
    decoded bytes, the trellis state after each piece and, at the
    punctured rates, the TS. Without fastlock (7/8) elections run on
    every 32nd chunk only, as the reference's resync_period has it."""
    cap_j, cap_t = [], []
    jfun = jvit._viterbi_chunk_device

    def jcap(*a):
        out = jfun(*a)
        cap_j.append((np.asarray(out[3]), np.asarray(out[4])))
        return out

    tname = "viterbi_acs" if rate == "1/2" else "viterbi_acs_banked"
    mod = tvd if rate == "1/2" else tvb
    tfun = getattr(mod, tname)

    def tcap(*a):
        out = tfun(*a)
        cap_t.append((out[-2].numpy().T, out[-1].numpy().T))
        return out

    monkeypatch.setattr(jvit, "_viterbi_chunk_device", jcap)
    monkeypatch.setattr(mod, tname, tcap)
    sym, cost = _tx_symbols(rate, npkt, seed=4, rot=1)
    j, t = _receivers(rate, fastlock=fastlock, viterbi=True)
    assert t.deconv.nsyncs == j.deconv.nsyncs == {"1/2": 4, "3/4": 8,
                                                  "7/8": 16}[rate]
    out_j, out_t = [], []
    for a in range(0, len(sym), 5003):
        s, c = sym[a:a + 5003], cost[a:a + 5003]
        bj, bt = j.deconv.process(s, c), t.deconv.process(s, c)
        np.testing.assert_array_equal(bj, bt, err_msg=f"bytes at {a}")
        assert j.deconv.current == t.deconv.current
        out_j.append(j._byte_stages(bj))
        out_t.append(t._byte_stages(bt))
        for k, want, got in _state_pairs(j, t, rate):
            np.testing.assert_array_equal(want, got, err_msg=f"{k} at {a}")
    assert len(cap_j) == len(cap_t) > 20
    for k, ((uj, qj), (ut, qt)) in enumerate(zip(cap_j, cap_t)):
        np.testing.assert_array_equal(uj, ut, err_msg=f"us, chunk {k}")
        np.testing.assert_array_equal(qj, qt, err_msg=f"q, chunk {k}")
    assert t.deconv.current != 0          # the rotation was elected away
    for k, (a, b) in enumerate(zip(out_j, out_t)):
        np.testing.assert_array_equal(a, b, err_msg=f"TS, piece {k}")
    if rate != "1/2":
        assert sum(len(o) for o in out_t) > 5
