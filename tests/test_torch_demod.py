"""The port's demod (leansdr_tpu_torch/dsp/receiver_kernel.py) against the
JAX Pallas demod kernel run in interpret mode on the CPU.

The JAX side runs in one child process for the whole module, with
multiply-add contraction off in XLA (XLA_FLAGS=--xla_cpu_max_isa=AVX: no
FMA instructions), so both sides round each float operation once, as the
port's plain version and its CUDA kernel (built with --fmad=false) do.

Tolerance: every packed word exactly equal, the words of samples that
are not emitted included. The 19 state planes exactly equal for QPSK at
the AGC setpoint; elsewhere within STATE_ULPS float32 ulps of the JAX
value (the largest gap seen is 5 ulps, on a plane of the 16APSK case;
ROADMAP queue 3 records it).
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from leansdr_tpu.dsp.cstln import Predef, make_dvbs2_constellation
from leansdr_tpu.pipelines import tsgen, dvbs_tx

from leansdr_tpu_torch.dsp import receiver as t_receiver
from leansdr_tpu_torch.dsp import receiver_kernel as rk

# Single-threaded torch: the plain versions run many small ops, which
# OpenMP threads only slow down, most of all beside other test workers.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FMA_OFF = "--xla_cpu_max_isa=AVX"
STATE_ULPS = 8


def _cases():
    """Every stimulus of the module by name: (predef name, rate, nsym,
    x [C, nsamp+1, 2] float32)."""
    rng = np.random.default_rng(9)
    switch = {f"switch{i}": (p.name, cr, m, _noisy_symbols(p, cr, m, 640,
                                                           rng)[None])
              for i, (p, cr, m) in enumerate(
                  ((Predef.QPSK, "1/2", 4), (Predef.PSK8, "2/3", 8),
                   (Predef.QPSK, "1/2", 4)))}
    return dict(
        qpsk=("QPSK", "1/2", 4, _qpsk_stimulus(30, 1280)),
        # x300 amplitudes exercise halving rounds 5..12 (sdr.h:470-485).
        huge=("QPSK", "1/2", 4, (_qpsk_stimulus(20, 1024)
                                 * np.float32(300.0)).astype(np.float32)),
        **{p.name: (p.name, cr, m, _noisy_symbols(
            p, cr, m, 1280, np.random.default_rng(5))[None])
           for p, cr, m in ((Predef.PSK8, "2/3", 8),
                            (Predef.APSK16, "3/4", 16))},
        **switch)


def _jax_demods(cases: dict) -> dict:
    """The JAX demod on every case: name -> (packed [nsamp, C], planes
    [19, C]). Runs in the child process (see jax_side)."""
    import jax.numpy as jnp
    from leansdr_tpu.dsp import receiver, receiver_pallas as rp
    out = {}
    for name, (predef, rate, nsym, x) in cases.items():
        C, nsamp = x.shape[0], x.shape[1] - 1
        params = receiver.ReceiverParams(omega=2.0, sampler="linear",
                                         nsymbols=nsym, exact_lut=False)
        st, packed = rp.demod_pallas(
            params, rp.sym_constants(make_dvbs2_constellation(
                Predef[predef], rate)),
            rp.pack_state(receiver.init_state(params, C)), jnp.asarray(x),
            interpret=True)
        out[name] = (np.asarray(packed).reshape(nsamp, -1)[:, :C],
                     np.asarray(st).reshape(rk.NSTATE, -1)[:, :C])
    return out


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """_jax_demods(_cases()) in one child process with FMA contraction
    off in XLA."""
    tmp = tmp_path_factory.mktemp("jax_demod")
    src, dst = tmp / "cases.pkl", tmp / "out.pkl"
    src.write_bytes(pickle.dumps(_cases()))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {FMA_OFF}",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    r = subprocess.run([sys.executable, __file__, str(src), str(dst)],
                       env=env, cwd=str(REPO), capture_output=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout.decode()[-4000:] + \
        r.stderr.decode()[-4000:]
    return pickle.loads(dst.read_bytes())


def _run_both(jax_side, name):
    """Case `name` through the port's demod -> (jax packed [nsamp, C],
    jax planes [19, C], port packed, port planes)."""
    predef, rate, nsym, x = _cases()[name]
    cstln = make_dvbs2_constellation(Predef[predef], rate)
    tparams = t_receiver.ReceiverParams(omega=2.0, sampler="linear",
                                        nsymbols=nsym, exact_lut=False)
    planes = rk.pack_state(t_receiver.init_state(tparams, x.shape[0], "cpu"))
    st_t, packed_t = rk.demod(tparams, rk.sym_constants(cstln), planes,
                              torch.from_numpy(np.ascontiguousarray(x)))
    pj, sj = jax_side[name]
    return pj, sj, packed_t.numpy(), st_t.numpy()


def _check(pj, sj, pt, st, ulps=0):
    diff = np.argwhere(pj != pt)
    assert not len(diff), (
        f"{len(diff)} packed words differ; first at (sample, channel) "
        f"{tuple(diff[0])}: jax {pj[tuple(diff[0])]:#x} "
        f"port {pt[tuple(diff[0])]:#x}")
    gap = (np.abs(st.astype(np.float64) - sj)
           / np.spacing(np.abs(sj)).astype(np.float64))
    row = int(gap.max(axis=1).argmax())
    assert gap.max() <= ulps, (f"state plane {row}: jax {sj[row]} port "
                               f"{st[row]} ({gap.max():.0f} ulps)")


def _qpsk_stimulus(npkt, nmax):
    iq = dvbs_tx.modulate(tsgen.generate(npkt),
                          dvbs_tx.TxConfig(rate="1/2", interp=2))
    n = min((len(iq) - 1) // 128 * 128, nmax)
    return iq[None, :n + 1, :]


def test_demod_matches_jax_qpsk(jax_side):
    pj, sj, pt, st = _run_both(jax_side, "qpsk")
    assert ((pj >> 24) & 1).sum() > 500
    _check(pj, sj, pt, st)


def test_demod_matches_jax_qpsk_huge_amplitudes(jax_side):
    """x300 amplitudes exercise halving rounds 5..12 (sdr.h:470-485)."""
    pj, sj, pt, st = _run_both(jax_side, "huge")
    _check(pj, sj, pt, st, STATE_ULPS)
    valid = ((pt >> 24) & 1).astype(bool)
    assert ((pt & 0xFFFF)[valid] != 0).any()     # costs not saturated


@pytest.mark.parametrize("predef,cr,nsym", [
    (Predef.PSK8, "2/3", 8),
    (Predef.APSK16, "3/4", 16),
])
def test_demod_matches_jax_nonqpsk(predef, cr, nsym, jax_side):
    """The generic nsym-way argmin branch, noisy random symbols at the
    AGC setpoint amplitude."""
    pj, sj, pt, st = _run_both(jax_side, predef.name)
    assert ((pt >> 24) & 1).sum() > 100
    _check(pj, sj, pt, st, STATE_ULPS)


def _noisy_symbols(predef, cr, nsym, n, rng):
    """[n+1, 2] float32: random symbols of the constellation at 2 samples
    per symbol, at the AGC setpoint amplitude, with noise."""
    pts = make_dvbs2_constellation(predef, cr).symbols.astype(np.float32)
    sym_ix = rng.integers(0, nsym, n // 2 + 2)
    base = np.repeat(pts[sym_ix], 2, axis=0)[: n + 1]
    return (base + rng.normal(scale=8.0, size=base.shape)).astype(np.float32)


def test_demod_constellation_switch_matches_jax(jax_side):
    """QPSK, then 8PSK, then QPSK again in one process, each equal to the
    JAX package's demod; the launch constants the CUDA path caches per
    (params, constellation, device) follow every switch (built for each
    new key, the same object for a key seen before)."""
    seen = []
    for i, (predef, cr, nsym) in enumerate(
            ((Predef.QPSK, "1/2", 4), (Predef.PSK8, "2/3", 8),
             (Predef.QPSK, "1/2", 4))):
        pj, sj, pt, st = _run_both(jax_side, f"switch{i}")
        assert ((pt >> 24) & 1).sum() > 50
        _check(pj, sj, pt, st, STATE_ULPS)
        sc = rk.sym_constants(make_dvbs2_constellation(predef, cr))
        tparams = t_receiver.ReceiverParams(omega=2.0, sampler="linear",
                                            nsymbols=nsym, exact_lut=False)
        args, sym = rk._launch_consts(tparams, sc, torch.device("cpu"))
        assert (args.nsym, args.qpsk) == (nsym, int(nsym == 4))
        assert torch.equal(sym, torch.tensor(sc, dtype=torch.float32))
        seen.append(args)
    assert seen[2] is seen[0] and seen[1] is not seen[0]


def _pe16_direct(i8, q8, phases):
    """pe16 as demod_ref computes it inline: atan2_poly less the QPSK
    symbol's phase, truncated to u16 angle units, sign-folded."""
    from leansdr_tpu_torch.dsp.math_utils import atan2_poly
    neg_i, neg_q = i8 < 0, q8 < 0
    ph = torch.where(neg_q, torch.where(neg_i, phases[3], phases[1]),
                     torch.where(neg_i, phases[2], phases[0]))
    pe_i = torch.trunc((atan2_poly(q8, i8) - ph) * rk.K16).to(torch.int32)
    return ((pe_i & 0xFFFF) ^ 0x8000) - 0x8000


@pytest.mark.parametrize("predef,cr", [(Predef.QPSK, "1/2"),
                                       (Predef.PSK8, "2/3")])
def test_pe16_table_ref_matches_direct(predef, cr):
    """The QPSK phase-error table on all 65536 (i8, q8) grid points
    equals the direct pe16, for QPSK's phases and for four other phases
    (8PSK's first four: a constellation switched to)."""
    phases = rk.sym_constants(make_dvbs2_constellation(predef, cr))[2]
    table = rk.pe16_table_ref(phases)
    assert table.dtype == torch.int16 and table.shape == (65536,)
    k = torch.arange(65536)
    i8 = (k // 256 - 128).to(torch.float32)
    q8 = (k % 256 - 128).to(torch.float32)
    ph = torch.tensor(phases[:4], dtype=torch.float32)
    direct = _pe16_direct(i8, q8, ph)
    assert torch.equal(table.to(torch.int32), direct)
    assert int(direct.min()) < -8000 and int(direct.max()) > 8000
    # -0.0 (a truncated small negative sample) reads as the +0.0 entry.
    z = torch.tensor([-0.0, 0.0, -0.0])
    o = torch.tensor([5.0, -0.0, -7.0])
    assert torch.equal(_pe16_direct(z, o, ph), _pe16_direct(z.abs(), o, ph))
    assert torch.equal(_pe16_direct(o, z, ph), _pe16_direct(o, z.abs(), ph))


def test_pe16_lookup_ref_falls_back_off_the_grid():
    """The table lookup with its fallback equals the direct pe16 on the
    huge-amplitudes stimulus quantized as the loop quantizes it: at the
    AGC's gains the halving keeps it on the grid; at gains past the cap
    of 12 halvings, and for NaN, it is off the grid and computed."""
    phases = rk.sym_constants(make_dvbs2_constellation(Predef.QPSK,
                                                       "1/2"))[2]
    table = rk.pe16_table_ref(phases)
    ph = torch.tensor(phases[:4], dtype=torch.float32)
    x = torch.from_numpy(_cases()["huge"][3][0])
    for gain, on_grid in ((1.0, True), (1.0 / 300, True),
                          (2.0 ** 12, False)):
        i8, q8 = rk.quantize_s8(x[:, 0] * gain, x[:, 1] * gain)
        on = (i8 >= -128) & (i8 <= 127) & (q8 >= -128) & (q8 <= 127)
        if on_grid:
            assert bool(on.all())
        else:
            assert 0 < int(on.sum()) < on.numel() // 2
        ph_sym = rk.qpsk_phase(i8 < 0, q8 < 0, ph)
        assert torch.equal(rk.pe16_lookup_ref(table, i8, q8, ph_sym),
                           _pe16_direct(i8, q8, ph))
    nan = torch.tensor([float("nan"), 3.0, float("nan")])
    other = torch.tensor([2.0, float("nan"), -128.0])
    for i8, q8 in ((nan, other), (other, nan)):
        got = rk.pe16_lookup_ref(table, i8, q8,
                                 rk.qpsk_phase(i8 < 0, q8 < 0, ph))
        assert torch.equal(got, _pe16_direct(i8, q8, ph))


@pytest.mark.parametrize("qpsk,C,sms,table", [
    (True, 1, 132, True), (True, 14, 132, True), (True, 64, 132, True),
    (True, 448, 132, True), (True, 512, 132, True),
    (True, 132 * 32, 132, True), (True, 132 * 32 + 1, 132, False),
    (True, 8192, 132, False), (False, 14, 132, False)])
def test_pe_table_taken_while_the_blocks_fit(qpsk, C, sms, table):
    """The QPSK launches of every main path (C <= 512) take the table; a
    launch whose 32-channel blocks outnumber the SMs keeps the layout
    without it, and so does every other constellation."""
    assert rk.use_pe_table(qpsk, C, sms) is table


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
    from leansdr_tpu.dsp import receiver_pallas as rp
    jp = np.asarray(rp.pack_state({k: v.numpy() for k, v in st.items()}))
    np.testing.assert_array_equal(jp.reshape(rk.NSTATE, -1)[:, :7],
                                  planes.numpy())


if __name__ == "__main__":
    # The JAX side of jax_side: python test_torch_demod.py CASES.pkl OUT.pkl
    cases = pickle.loads(Path(sys.argv[1]).read_bytes())
    Path(sys.argv[2]).write_bytes(pickle.dumps(_jax_demods(cases)))
