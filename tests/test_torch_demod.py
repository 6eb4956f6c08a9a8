"""The port's demod (leansdr_tpu_torch/dsp/receiver_kernel.py) against the
JAX Pallas demod kernel run in interpret mode on the CPU.

Tolerance: valid must be exactly equal on every sample, and symbol and
cost exactly equal on every valid sample (as tests/test_receiver_pallas
compares; on the other samples the packed word holds the decision of a
point that is never emitted and is thrown away downstream). Loop state is float32 and its rounding differs
between XLA and PyTorch (XLA contracts multiply-adds and has its own
cos/sin), so mu, freqw, agc_gain and est_insp must agree within
max(1e-3, 1e-4*|v|), the bar tests/test_receiver_pallas.py sets for the
kernel against the scan path.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from leansdr_tpu.dsp import receiver, receiver_pallas as rp
from leansdr_tpu.dsp.cstln import Predef, make_dvbs2_constellation
from leansdr_tpu.pipelines import tsgen, dvbs_tx

from leansdr_tpu_torch.dsp import receiver as t_receiver
from leansdr_tpu_torch.dsp import receiver_kernel as rk

# Single-threaded torch: the plain versions run many small ops, which
# OpenMP threads only slow down, most of all beside other test workers.
torch.set_num_threads(1)

STATE_KEYS = {"mu": 0, "freqw": 2, "agc_gain": 3, "est_insp": 4}


def _run_both(predef, rate, nsym, x):
    """x [C, nsamp+1, 2] float32 -> (jax packed [nsamp, C], jax planes
    [19, C], port packed, port planes)."""
    cstln = make_dvbs2_constellation(predef, rate)
    C = x.shape[0]
    nsamp = x.shape[1] - 1
    params = receiver.ReceiverParams(omega=2.0, sampler="linear",
                                     nsymbols=nsym, exact_lut=False)
    st_j, packed_j = rp.demod_pallas(
        params, rp.sym_constants(cstln),
        rp.pack_state(receiver.init_state(params, C)), jnp.asarray(x),
        interpret=True)
    tparams = t_receiver.ReceiverParams(omega=2.0, sampler="linear",
                                        nsymbols=nsym, exact_lut=False)
    planes = rk.pack_state(t_receiver.init_state(tparams, C, "cpu"))
    st_t, packed_t = rk.demod(tparams, rk.sym_constants(cstln), planes,
                              torch.from_numpy(np.ascontiguousarray(x)))
    return (np.asarray(packed_j).reshape(nsamp, -1)[:, :C],
            np.asarray(st_j).reshape(rk.NSTATE, -1)[:, :C],
            packed_t.numpy(), st_t.numpy())


def _check(pj, sj, pt, st):
    vj = (pj >> 24) & 1
    vt = (pt >> 24) & 1
    diff = np.argwhere((vj != vt) | ((pj != pt) & (vj == 1)))
    assert not len(diff), (
        f"{len(diff)} packed samples differ; first at (sample, channel) "
        f"{tuple(diff[0])}: jax {pj[tuple(diff[0])]:#x} "
        f"port {pt[tuple(diff[0])]:#x}")
    for k, row in STATE_KEYS.items():
        v = sj[row]
        np.testing.assert_allclose(
            st[row], v, rtol=0, atol=max(1e-3, 1e-4 * np.abs(v).max()),
            err_msg=k)


def _qpsk_stimulus(npkt, nmax):
    iq = dvbs_tx.modulate(tsgen.generate(npkt),
                          dvbs_tx.TxConfig(rate="1/2", interp=2))
    n = min((len(iq) - 1) // 128 * 128, nmax)
    return iq[None, :n + 1, :]


def test_demod_matches_jax_qpsk():
    pj, sj, pt, st = _run_both(Predef.QPSK, "1/2", 4,
                               _qpsk_stimulus(30, 1280))
    assert ((pj >> 24) & 1).sum() > 500
    _check(pj, sj, pt, st)


def test_demod_matches_jax_qpsk_huge_amplitudes():
    """x300 amplitudes exercise halving rounds 5..12 (sdr.h:470-485)."""
    x = (_qpsk_stimulus(20, 1024) * np.float32(300.0)).astype(np.float32)
    pj, sj, pt, st = _run_both(Predef.QPSK, "1/2", 4, x)
    _check(pj, sj, pt, st)
    valid = ((pt >> 24) & 1).astype(bool)
    assert ((pt & 0xFFFF)[valid] != 0).any()     # costs not saturated


@pytest.mark.parametrize("predef,cr,nsym", [
    (Predef.PSK8, "2/3", 8),
    (Predef.APSK16, "3/4", 16),
])
def test_demod_matches_jax_nonqpsk(predef, cr, nsym):
    """The generic nsym-way argmin branch, noisy random symbols at the
    AGC setpoint amplitude."""
    x = _noisy_symbols(predef, cr, nsym, 1280, np.random.default_rng(5))
    pj, sj, pt, st = _run_both(predef, cr, nsym, x[None])
    assert ((pt >> 24) & 1).sum() > 100
    _check(pj, sj, pt, st)


def _noisy_symbols(predef, cr, nsym, n, rng):
    """[n+1, 2] float32: random symbols of the constellation at 2 samples
    per symbol, at the AGC setpoint amplitude, with noise."""
    pts = make_dvbs2_constellation(predef, cr).symbols.astype(np.float32)
    sym_ix = rng.integers(0, nsym, n // 2 + 2)
    base = np.repeat(pts[sym_ix], 2, axis=0)[: n + 1]
    return (base + rng.normal(scale=8.0, size=base.shape)).astype(np.float32)


def test_demod_constellation_switch_matches_jax():
    """QPSK, then 8PSK, then QPSK again in one process, each equal to the
    JAX package's demod; the launch constants the CUDA path caches per
    (params, constellation, device) follow every switch (built for each
    new key, the same object for a key seen before)."""
    rng = np.random.default_rng(9)
    seen = []
    for predef, cr, nsym in ((Predef.QPSK, "1/2", 4), (Predef.PSK8, "2/3", 8),
                             (Predef.QPSK, "1/2", 4)):
        x = _noisy_symbols(predef, cr, nsym, 640, rng)
        pj, sj, pt, st = _run_both(predef, cr, nsym, x[None])
        assert ((pt >> 24) & 1).sum() > 50
        _check(pj, sj, pt, st)
        sc = rk.sym_constants(make_dvbs2_constellation(predef, cr))
        tparams = t_receiver.ReceiverParams(omega=2.0, sampler="linear",
                                            nsymbols=nsym, exact_lut=False)
        args, sym = rk._launch_consts(tparams, sc, torch.device("cpu"))
        assert (args.nsym, args.qpsk) == (nsym, int(nsym == 4))
        assert torch.equal(sym, torch.tensor(sc, dtype=torch.float32))
        seen.append(args)
    assert seen[2] is seen[0] and seen[1] is not seen[0]


def test_state_pack_roundtrip():
    params = t_receiver.ReceiverParams(omega=1.5, nsymbols=4)
    st = t_receiver.init_state(params, 7, "cpu")
    st["mu"] = torch.arange(7, dtype=torch.float32)
    st["hist_p"] = torch.arange(7 * 6, dtype=torch.float32).reshape(7, 3, 2)
    st["hist_c"] = -st["hist_p"]
    planes = rk.pack_state(st)
    assert planes.shape == (rk.NSTATE, 7)
    back = rk.unpack_state(planes)
    for k in ("mu", "phase", "freqw", "agc_gain", "est_insp", "hist_p",
              "hist_c"):
        assert torch.equal(back[k], st[k]), k
    # Same plane order as the JAX kernel's [19, nsub, 128] layout.
    jp = np.asarray(rp.pack_state({k: v.numpy() for k, v in st.items()}))
    np.testing.assert_array_equal(jp.reshape(rk.NSTATE, -1)[:, :7],
                                  planes.numpy())
