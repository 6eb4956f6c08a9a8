"""The port's punctured-rate fleet decoder (leansdr_tpu_torch/fec/
viterbi_device.py `MultiViterbiSync`, `viterbi_decode_banked` on the plain
banked ACS) against the JAX fleet decoder: at 7/8 its XLA-scan decoder,
at 3/4 its banked Pallas kernel in interpret mode.

Tolerance: none. Bytes, discriminants with the election, underflow,
trellis planes and the ring are integers and must be equal bit for bit.
"""

import numpy as np
import jax.numpy as jnp
import torch

from leansdr_tpu.dsp.cstln import Predef, make_dvbs2_constellation
from leansdr_tpu.fec import viterbi as vit
from leansdr_tpu.fec import viterbi_device as jvd

from leansdr_tpu_torch.fec import viterbi_banked as tvb
from leansdr_tpu_torch.fec import viterbi_device as tvd

# Single-threaded torch: the plain versions run many small ops, which
# OpenMP threads only slow down, most of all beside other test workers.
torch.set_num_threads(1)


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
