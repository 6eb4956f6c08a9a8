"""The port's banked punctured-rate ACS (leansdr_tpu_torch/fec/
viterbi_banked.py) and its block inputs against the JAX package: the
bank geometry, the host ViterbiBank (fec/viterbi.py) and
`_punctured_block_inputs(_tracked)`. The comparisons with the JAX
kernel and its XLA scan are in tests/test_torch_banked_kernel.py, the
fleet decodes in tests/test_torch_fleet_decode.py.

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

# Single-threaded torch: the plain versions run many small ops, which
# OpenMP threads only slow down, most of all beside other test workers.
torch.set_num_threads(1)

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
