"""The port's rate-1/2 ACS and fleet Viterbi
(leansdr_tpu_torch/fec/viterbi_device.py) against the JAX host bank
(fec/viterbi.ViterbiBank), the JAX Pallas ACS kernel in interpret mode,
and the JAX fleet decoder; and a NumPy model of csrc/acs.cu's lagged
normalisation (block t subtracts its input's least metric, known from
block t-1's best key) against `viterbi_acs_ref` and the JAX kernel.

Tolerance: none. Metrics, paths, decoded bits, discriminants, bytes and
elections are integers and must be equal bit for bit, ties included
(small integer costs make metric ties frequent).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from leansdr_tpu.dsp.cstln import Predef, make_dvbs2_constellation
from leansdr_tpu.fec import convenc, viterbi as vit
from leansdr_tpu.fec import viterbi_device as jvd

from leansdr_tpu_torch.fec import viterbi_device as tvd

# Single-threaded torch: the plain versions run many small ops, which
# OpenMP threads only slow down, most of all beside other test workers.
torch.set_num_threads(1)

RATE = "1/2"
INT16 = (-(1 << 15), (1 << 15) - 1)      # the callers' cost range


def _tie_inputs(T, N, seed=7):
    rng = np.random.default_rng(seed)
    cs = rng.integers(0, 4, (T, N)).astype(np.int32)
    cost = -rng.integers(0, 4, (T, N)).astype(np.int32)
    return cs, cost


def _run_ref(cs, cost, cheap_q=False, metric=None, path=None):
    N = cs.shape[1]
    z = torch.zeros((64, N), dtype=torch.int32)
    return tvd.viterbi_acs(
        RATE, z if metric is None else metric, z if path is None else path,
        torch.from_numpy(cs), torch.from_numpy(cost), cheap_q=cheap_q)


def test_acs_ref_matches_host_bank():
    T, N = tvd.P_SUB, 128
    cs, cost = _tie_inputs(T, N)
    m, p, us, q = _run_ref(cs, cost)
    bank = vit.ViterbiBank(vit.make_trellis(RATE), N)
    idx = np.arange(N)
    for t in range(T):
        bus, bq = bank.update(idx, cs[t].astype(np.int64),
                              cost[t].astype(np.int64))
        assert np.array_equal(us[t].numpy(), bus), f"us at block {t}"
        assert np.array_equal(q[t].numpy(), bq), f"q at block {t}"
    assert np.array_equal(m.numpy(), bank.cost.T.astype(np.int32))
    assert np.array_equal(p.numpy().astype(np.uint32),
                          (bank.path & np.uint64(0xFFFFFFFF)
                           ).T.astype(np.uint32))


@pytest.mark.parametrize("cheap_q", [False, True])
def test_acs_ref_matches_jax_kernel(cheap_q):
    """Against the Pallas kernel itself, from a non-zero trellis state
    (the end state of a first tile), with and without cheap_q."""
    T, N = tvd.P_SUB, 128
    cs0, cost0 = _tie_inputs(T, N, seed=1)
    m0, p0, _, _ = _run_ref(cs0, cost0)
    cs, cost = _tie_inputs(T, N, seed=2)
    jm, jp, jus, jq = jvd.viterbi_acs(
        RATE, jnp.asarray(m0.numpy()), jnp.asarray(p0.numpy()),
        jnp.asarray(cs), jnp.asarray(cost), interpret=True, cheap_q=cheap_q)
    out = _run_ref(cs, cost, cheap_q, m0, p0)
    for name, a, b in zip(("metric", "path", "us", "q"),
                          (jm, jp, jus, jq), out):
        a = np.asarray(a)
        b = b.numpy()
        bad = np.argwhere(a != b)
        assert not len(bad), (f"{name}: {len(bad)} differ, first "
                              f"{tuple(bad[0])}: jax {a[tuple(bad[0])]} "
                              f"port {b[tuple(bad[0])]}")
    if cheap_q:
        assert not out[3].numpy()[1::4].any()


@pytest.mark.parametrize("track", [False, True])
def test_fleet_decode_matches_jax(track):
    """MultiViterbiSync: ring append + one decode (ACQUIRE: all 4 sync
    replicas and the per-sub-block election; TRACK: the elected replica
    with the cheap_q discriminant) equal to the JAX fleet decoder."""
    cstln = make_dvbs2_constellation(Predef.QPSK, RATE)
    C = 3
    nsamp = 2 * tvd.P_SUB + 256
    rng = np.random.default_rng(3)
    maps = vit.make_sync_maps(cstln, RATE)[0]
    syms = np.zeros((nsamp, C), np.uint8)
    for c, rot in enumerate([0, 1, 3]):
        data = rng.integers(0, 256, nsamp // 8, dtype=np.uint8)
        cs, _ = convenc.encode(data, RATE, 2)
        syms[:, c] = np.argsort(maps[rot])[cs]
    flip = rng.random((nsamp, C)) < 0.03         # a few hard errors
    syms[flip] ^= 1
    costs = -rng.integers(1, 60, (nsamp, C)).astype(np.int16)
    valid = rng.random((nsamp, C)) < 0.97

    mj = jvd.MultiViterbiSync(cstln, RATE, C, nsamp, 1.0, interpret=True)
    mt = tvd.MultiViterbiSync(cstln, RATE, C, nsamp, 1.0, device="cpu")
    assert mt.plan.E == mj.plan.E and mt.plan.cap == mj.plan.cap
    if track:
        cur = np.array([1, 0, 3], np.int32)
        mj.state = dict(mj.state, current=jnp.asarray(cur))
        mt.state = dict(mt.state, current=torch.from_numpy(cur))
        mj._want_track = mt._want_track = True
    mj.append(jnp.asarray(syms), jnp.asarray(valid), jnp.asarray(costs))
    mt.append(torch.from_numpy(syms), torch.from_numpy(valid),
              torch.from_numpy(costs))
    mj.note_production(nsamp)
    mt.note_production(nsamp)
    assert mj.can_decode() and mt.can_decode()
    out_j, out_t = mj.decode(), mt.decode()
    assert not out_t[2].any()            # every channel's ring holds a decode
    for name, a, b in zip(("bytes", "discr", "under"), out_j, out_t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=name)
    assert mt.track == track
    for k in ("fill", "current", "tsync"):
        np.testing.assert_array_equal(np.asarray(mj.state[k]),
                                      mt.state[k].numpy(), err_msg=k)
    lanes = C if track else C * tvd.NSYNCS
    for k in ("metric", "path"):
        np.testing.assert_array_equal(np.asarray(mj.state[k])[:, :lanes],
                                      mt.state[k].numpy(), err_msg=k)


def _lagged_acs_model(metric, path, cs, cost, cheap_q=False):
    """NumPy model of csrc/acs.cu: the reference's butterfly and packed
    keys, but block t's new metrics less s_t, the least metric of its
    input planes (s_0 from the input; s_{t+1} = (best key >> 7) - s_t),
    and s_T subtracted after the last block. In int64, so that nothing
    wraps. Returns (metric, path, us, q, the largest |key| met)."""
    nbits, depth = tvd.PATH_SPEC[RATE]
    shift = (depth - 1) * nbits
    ce, co, sw = (a[:, :, None] for a in tvd._butterfly_tables(RATE))
    swb = sw.astype(bool)
    sidx = np.arange(32)[None, :, None] + np.array([0, 32])[:, None, None]
    T, N = cs.shape
    m = metric.astype(np.int64)
    p = path.astype(np.int64) & 0xFFFFFFFF
    s = m.min(axis=0)
    us = np.zeros((T, N), np.int64)
    q = np.zeros((T, N), np.int64)
    widest = 0
    for t in range(T):
        cs_b, c_b = cs[t][None].astype(np.int64), cost[t][None].astype(
            np.int64)
        me, mo, pe, po = m[0::2], m[1::2], p[0::2], p[1::2]
        nms, nps, keys = [], [], []
        for h in range(2):
            match_o = co[h] == cs_b
            Me = me + np.where(ce[h] == cs_b, c_b, 0)
            Mo = mo + np.where(match_o, c_b, 0)
            nm = np.minimum(Me, Mo)
            m_first = np.where(swb[h], mo, me)
            m_second = np.where(swb[h], me, mo)
            sel_odd = np.where(m_second == nm, ~swb[h],
                               np.where(m_first == nm, swb[h], match_o))
            npth = ((np.where(sel_odd, po, pe) << 1) | h) & 0xFFFFFFFF
            keys.append(((nm * 64 + sidx[h]) << 1) | ((npth >> shift) & 1))
            nms.append(nm)
            nps.append(npth)
        key = np.concatenate(keys)
        widest = max(widest, int(np.abs(key).max()))
        best = key.min(axis=0)
        r = best >> 7
        us[t] = best & 1
        if not cheap_q or t % 4 == 0:
            q[t] = (np.where(key == best, tvd.BIG, key).min(axis=0) >> 7) - r
        m = np.concatenate(nms) - s
        p = np.concatenate(nps)
        s = r - s
    return m - s, p, us, q, widest


def _extreme_inputs(T, N, seed):
    """Costs at the callers' int16 extremes (and 0), at random, and
    coded symbols in 0..3."""
    rng = np.random.default_rng(seed)
    cs = rng.integers(0, 4, (T, N)).astype(np.int32)
    pick = rng.integers(0, 4, (T, N))
    cost = np.where(pick == 0, INT16[0], np.where(
        pick == 1, INT16[1], np.where(pick == 2, 0, rng.integers(
            INT16[0], INT16[1] + 1, (T, N))))).astype(np.int32)
    return cs, cost


def _same(model, port):
    for name, a, b in zip(("metric", "path", "us", "q"), model[:4], port):
        b = b.numpy().astype(np.int64)
        if name == "path":
            b = b & 0xFFFFFFFF
        bad = np.argwhere(a != b)
        assert not len(bad), (f"{name}: {len(bad)} differ, first "
                              f"{tuple(bad[0])}: model {a[tuple(bad[0])]} "
                              f"port {b[tuple(bad[0])]}")


@pytest.mark.parametrize("inputs", ["ties", "extreme"])
@pytest.mark.parametrize("cheap_q", [False, True])
def test_lagged_normalisation_model_matches_ref(inputs, cheap_q):
    """The kernel's lagged normalisation gives the reference's outputs
    bit for bit (m, p, us, q), ties included, over 256 blocks (256
    normalisations), from zero planes and from the live end state of a
    first run; at the int16 cost extremes every key stays within the
    headroom csrc/acs.cu states (|key| < 2^26, under BIG = 2^30)."""
    T, N = 256, 64
    make = _tie_inputs if inputs == "ties" else _extreme_inputs
    m0 = p0 = np.zeros((64, N), np.int32)
    for rnd in range(2):
        cs, cost = make(T, N, seed=10 + rnd)
        model = _lagged_acs_model(m0, p0, cs, cost, cheap_q)
        port = _run_ref(cs, cost, cheap_q, torch.from_numpy(m0),
                        torch.from_numpy(p0))
        _same(model, port)
        assert model[4] < 1 << 26
        if inputs == "extreme":
            assert model[4] > 1 << 20        # the extremes were reached
        m0, p0 = port[0].numpy(), port[1].numpy()
    if cheap_q:
        assert not model[3][1::4].any()


@pytest.mark.parametrize("cheap_q", [False, True])
def test_lagged_normalisation_model_matches_jax_kernel(cheap_q):
    """The model against the Pallas kernel itself, at the int16 cost
    extremes, from the live end state of a tie-heavy first tile."""
    T, N = tvd.P_SUB, 128
    cs0, cost0 = _tie_inputs(T, N, seed=3)
    m0, p0, _, _ = _run_ref(cs0, cost0)
    cs, cost = _extreme_inputs(T, N, seed=4)
    jm, jp, jus, jq = jvd.viterbi_acs(
        RATE, jnp.asarray(m0.numpy()), jnp.asarray(p0.numpy()),
        jnp.asarray(cs), jnp.asarray(cost), interpret=True, cheap_q=cheap_q)
    model = _lagged_acs_model(m0.numpy(), p0.numpy(), cs, cost, cheap_q)
    _same(model, tuple(torch.from_numpy(np.array(a))
                       for a in (jm, jp, jus, jq)))
    assert model[4] < 1 << 26
