"""The port's banked punctured-rate ACS (leansdr_tpu_torch/fec/
viterbi_banked.py) and its block inputs against the JAX package: the
bank geometry, the host ViterbiBank (fec/viterbi.py), the Pallas banked
kernel in interpret mode, `_punctured_block_inputs(_tracked)` and the
XLA fleet decoder at 7/8.

Tolerance: none. Geometry, metrics, 64-bit paths, decoded symbols,
discriminants, block inputs and bytes are integers and must be equal
bit for bit, ties included (coarse costs make metric ties frequent).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from leansdr_tpu.dsp.cstln import Predef, make_dvbs2_constellation
from leansdr_tpu.fec import viterbi as vit
from leansdr_tpu.fec import viterbi_banked as jvb
from leansdr_tpu.fec import viterbi_device as jvd

from leansdr_tpu_torch.fec import viterbi_banked as tvb
from leansdr_tpu_torch.fec import viterbi_device as tvd

RATES = ("4/6", "3/4", "5/6", "7/8")


def _tie_inputs(rate, T, N, seed):
    rng = np.random.default_rng(seed)
    cs = rng.integers(0, vit.make_trellis(rate).ncs, (T, N)).astype(np.int32)
    cost = -(rng.integers(0, 4, (T, N)) * 3).astype(np.int32)
    return cs, cost


def _ref(rate, cs, cost, planes=None):
    N = cs.shape[1]
    z = torch.zeros((64, N), dtype=torch.int32)
    m, h, lo = planes if planes is not None else (z, z, z)
    return tvb.viterbi_acs_banked(rate, m, h, lo, torch.from_numpy(cs),
                                  torch.from_numpy(cost))


@pytest.mark.parametrize("rate", RATES)
def test_bank_geometry_matches_jax(rate):
    """Every field of BankGeometry equals the JAX one; the kernel's
    packed tables decode back to it."""
    a, b = jvb.bank_geometry(rate), tvb.bank_geometry(rate)
    for f in ("rate", "B", "K", "G", "ncs", "rank_bits"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("rho", "orig", "pred_row", "cs", "us", "cs2", "us_hi",
              "us_lo"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=f)
    tbl, prow = tvb.kernel_tables(rate)
    assert tbl.shape == (b.K, 64) and prow.shape == (b.G * b.K,)
    np.testing.assert_array_equal(prow, a.pred_row.reshape(-1))
    for r in range(64):
        g, j = (r // b.K, r % b.K) if b.B <= 5 else (0, r)
        np.testing.assert_array_equal(tbl[:, r] & 0xFF,
                                      a.ncs - 1 - a.cs[g, :, j])
        if a.cs2 is not None:
            np.testing.assert_array_equal((tbl[:, r] >> 8) & 0xFF,
                                          a.ncs - 1 - a.cs2[0, :, j])
            np.testing.assert_array_equal((tbl[:, r] >> 16) & 0x7F,
                                          a.us_hi[0, :, j])
            np.testing.assert_array_equal((tbl[:, r] >> 23) & 0x7F,
                                          a.us_lo[0, :, j])
        else:
            assert ((tbl[:, r] >> 16) & 0x7F == a.us[g, j]).all()


@pytest.mark.parametrize("rate", RATES)
def test_banked_ref_matches_host_bank(rate):
    """viterbi_acs_banked_ref == ViterbiBank block by block: decoded
    symbols, discriminants, then metrics and the 64-bit paths (to their
    traceback depth) under the stored-row permutation."""
    geo = tvb.bank_geometry(rate)
    t = vit.make_trellis(rate)
    T, N = 512, 48
    cs, cost = _tie_inputs(rate, T, N, seed=11)
    m, h, lo, us, q = _ref(rate, cs, cost)
    bank = vit.ViterbiBank(t, N)
    idx = np.arange(N)
    for tt in range(T):
        bus, bq = bank.update(idx, cs[tt].astype(np.int64),
                              cost[tt].astype(np.int64))
        assert np.array_equal(us[tt].numpy(), bus), f"us at block {tt}"
        assert np.array_equal(q[tt].numpy(), bq), f"q at block {tt}"
    np.testing.assert_array_equal(
        m.numpy(), bank.cost[:, geo.orig].T.astype(np.int32))
    p64 = ((h.numpy().astype(np.uint32).astype(np.uint64) << np.uint64(32))
           | lo.numpy().astype(np.uint32))
    nbits, depth = vit.PATH_SPEC[rate]
    pmask = np.uint64((1 << min(63, nbits * depth)) - 1)
    np.testing.assert_array_equal(p64 & pmask,
                                  bank.path[:, geo.orig].T & pmask)


@pytest.mark.parametrize("rate", ["3/4", "5/6"])
def test_banked_ref_matches_jax_kernel(rate):
    """Against the Pallas banked kernel itself (3/4: its unrolled form,
    5/6: its fori form), from a non-zero trellis state (the end state of
    a first tile): metric, hi, lo, us and q all equal."""
    T, N = jvb.P_SUB, 128
    cs0, cost0 = _tie_inputs(rate, T, N, seed=1)
    start = _ref(rate, cs0, cost0)[:3]
    cs, cost = _tie_inputs(rate, T, N, seed=2)
    want = jvb.viterbi_acs_banked(
        rate, *(jnp.asarray(p.numpy()) for p in start), jnp.asarray(cs),
        jnp.asarray(cost), interpret=True)
    got = _ref(rate, cs, cost, start)
    for name, a, b in zip(("metric", "hi", "lo", "us", "q"), want, got):
        a, b = np.asarray(a), b.numpy()
        bad = np.argwhere(a != b)
        assert not len(bad), (f"{name}: {len(bad)} differ, first "
                              f"{tuple(bad[0])}: jax {a[tuple(bad[0])]} "
                              f"port {b[tuple(bad[0])]}")


def _plan_maps(rate, C):
    t = vit.make_trellis(rate)
    ns = t.bits_out // 2
    plan = jvd.ViterbiPlan(rate, C, jvd.P_SUB * ns, ns, 1,
                           4 * jvd.P_SUB * ns, nsyncs=4 * ns)
    tplan = tvd.ViterbiPlan(rate, C, plan.nsamp, ns, 1, plan.cap,
                            nsyncs=4 * ns)
    cstln = make_dvbs2_constellation(Predef.QPSK, rate)
    maps = tuple(tuple(int(v) for v in row)
                 for row in vit.make_sync_maps(cstln, rate)[0])
    return plan, tplan, maps


@pytest.mark.parametrize("rate", ["3/4", "7/8"])
def test_punctured_block_inputs_match_jax(rate):
    """All-replica block inputs (lane order c*nsyncs + shift*M + map) and
    the TRACK-mode elected-only inputs, for every possible election
    (one channel per sync replica), equal JAX's."""
    ns = vit.make_trellis(rate).bits_out // 2
    C = 4 * ns
    plan, tplan, maps = _plan_maps(rate, C)
    rng = np.random.default_rng(11)
    sym = rng.integers(0, 4, (plan.needed, C)).astype(np.uint8)
    cost = -rng.integers(0, 50, (plan.needed, C)).astype(np.int16)
    jcs, jcost = jvd._punctured_block_inputs(
        plan, maps, jnp.asarray(sym.astype(np.int32)),
        jnp.asarray(cost.astype(np.int32)))
    tcs, tcost = tvd._punctured_block_inputs(
        tplan, maps, torch.from_numpy(sym), torch.from_numpy(cost))
    np.testing.assert_array_equal(np.asarray(jcs), tcs.numpy())
    np.testing.assert_array_equal(np.asarray(jcost), tcost.numpy())
    tsync = np.arange(C, dtype=np.int32)
    jplan = jvd.ViterbiPlan(rate, C, plan.nsamp, ns, 1, plan.cap, nsyncs=1)
    tp1 = tvd.ViterbiPlan(rate, C, plan.nsamp, ns, 1, plan.cap, nsyncs=1)
    jcs, jcost = jvd._punctured_block_inputs_tracked(
        jplan, maps, jnp.asarray(sym.astype(np.int32)),
        jnp.asarray(cost.astype(np.int32)), jnp.asarray(tsync))
    tcs, tcost = tvd._punctured_block_inputs_tracked(
        tp1, maps, torch.from_numpy(sym), torch.from_numpy(cost),
        torch.from_numpy(tsync))
    np.testing.assert_array_equal(np.asarray(jcs), tcs.numpy())
    np.testing.assert_array_equal(np.asarray(jcost), tcost.numpy())


def test_fleet_decode_7_8_matches_jax_xla():
    """MultiViterbiSync at 7/8 (16 sync replicas per channel) against the
    JAX fleet's XLA-scan decoder (banked=False) in ACQUIRE, over two
    decodes: bytes, discriminants with the election, underflow, and the
    trellis planes (JAX keeps them [S, 64] in natural state order)."""
    rate, C = "7/8", 3
    cstln = make_dvbs2_constellation(Predef.QPSK, rate)
    nsamp = 1 << 13
    a = jvd.MultiViterbiSync(cstln, rate, C, nsamp, 2.0, banked=False)
    b = tvd.MultiViterbiSync(cstln, rate, C, nsamp, 2.0, device="cpu")
    assert a.xla and b.kind == "viterbi_banked"
    assert a.plan.E == b.plan.E and a.plan.nsyncs == b.plan.nsyncs == 16
    rng = np.random.default_rng(5)
    for it in range(2):
        n = a.plan.consumed + (a.plan.nshifts if it == 0 else 0)
        sym = rng.integers(0, 4, (n, C)).astype(np.uint8)
        val = np.ones((n, C), bool)
        cost = -(rng.integers(0, 4, (n, C)) * 3).astype(np.int16)
        a.append(jnp.asarray(sym), jnp.asarray(val), jnp.asarray(cost))
        b.append(torch.from_numpy(sym), torch.from_numpy(val),
                 torch.from_numpy(cost))
        out_a, out_b = a.decode(), b.decode()
        for name, x, y in zip(("bytes", "discr", "under"), out_a, out_b):
            np.testing.assert_array_equal(np.asarray(x), y.numpy(),
                                          err_msg=f"{name}, decode {it}")
    assert not b.track
    orig = tvb.bank_geometry(rate).orig
    for k in ("metric", "path_hi", "path_lo"):
        want = np.asarray(a.state[k]).view(np.int32).T[orig]
        np.testing.assert_array_equal(want, b.state[k].numpy(), err_msg=k)
    for k in ("fill", "current"):
        np.testing.assert_array_equal(np.asarray(a.state[k]),
                                      b.state[k].numpy(), err_msg=k)
    held = int(b.state["fill"].min())       # rows past the fill are garbage
    for k in ("buf", "cost"):
        np.testing.assert_array_equal(np.asarray(a.state[k])[:held],
                                      b.state[k].numpy()[:held], err_msg=k)


def test_fleet_decode_3_4_matches_jax_banked():
    """MultiViterbiSync at 3/4 against the JAX fleet decoder on its
    banked Pallas kernel (interpret mode): one ACQUIRE decode over all 8
    sync replicas (channels sent under different rotations, one of them
    a symbol late, so different maps and shifts win the election), then
    the switch to TRACK and one decode of the elected replicas. Bytes,
    discriminants, underflow, elections and the trellis planes over the
    port's lanes are equal."""
    from leansdr_tpu.fec import convenc
    rate, C = "3/4", 3
    cstln = make_dvbs2_constellation(Predef.QPSK, rate)
    nsamp = 1 << 12
    mj = jvd.MultiViterbiSync(cstln, rate, C, nsamp, 2.0, banked=True,
                              interpret=True)
    mt = tvd.MultiViterbiSync(cstln, rate, C, nsamp, 2.0, device="cpu")
    assert mj.kind == mt.kind == "viterbi_banked"
    assert repr(mt.plan).split("(")[1] == repr(mj.plan).split("(")[1]
    assert mt.plan.n_lanes == C * 8
    maps = vit.make_sync_maps(cstln, rate)[0]
    rng = np.random.default_rng(3)
    n = 3 * mj.plan.consumed
    syms = np.zeros((n, C), np.uint8)
    for c, (rot, late) in enumerate([(0, 0), (1, 1), (3, 0)]):
        data = rng.integers(0, 256, 3 * n // 8 // 4 * 4, dtype=np.uint8)
        cs, _ = convenc.encode(data, rate, 2)
        syms[late:, c] = np.argsort(maps[rot])[cs[:n - late]]
    syms[rng.random((n, C)) < 0.02] ^= 1          # a few hard errors
    costs = -rng.integers(1, 60, (n, C)).astype(np.int16)
    valid = np.ones((n, C), bool)
    for step, (lo, hi) in enumerate([(0, n // 3 + 1), (n // 3 + 1, n)]):
        if step == 1:
            mj._want_track = mt._want_track = True
        mj.append(jnp.asarray(syms[lo:hi]), jnp.asarray(valid[lo:hi]),
                  jnp.asarray(costs[lo:hi]))
        mt.append(torch.from_numpy(syms[lo:hi]),
                  torch.from_numpy(valid[lo:hi]),
                  torch.from_numpy(costs[lo:hi]))
        out_j, out_t = mj.decode(), mt.decode()
        assert not out_t[2].any()
        for name, a, b in zip(("bytes", "discr", "under"), out_j, out_t):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f"{name}, step {step}")
        assert mt.track == bool(step)
        lanes = C if step else C * 8
        for k in ("fill", "current", "tsync"):
            np.testing.assert_array_equal(np.asarray(mj.state[k]),
                                          mt.state[k].numpy(), err_msg=k)
        for k in ("metric", "path_hi", "path_lo"):
            np.testing.assert_array_equal(
                np.asarray(mj.state[k])[:, :lanes], mt.state[k].numpy(),
                err_msg=f"{k}, step {step}")
    # The stimulus made the election pick other syncs than 0.
    assert len(set(mt.state["tsync"].tolist())) > 1
