"""The port's scan demod (leansdr_tpu_torch.dsp.receiver: run_chunks_ref,
the plain version of csrc/scan_demod.cu) against the JAX scan
(leansdr_tpu.dsp.receiver.run_chunks), and the modules under it
(math_utils.expi_float, cstln.lookup_float, make_tables, init_state).

Cases: each sampler (nearest, linear, rrc) x decision mode (exact_lut:
the trig16 table and the 256x256 LUT; computed), QPSK, 3 channels at 2
samples per symbol with fractional delays, carrier offsets and noise,
two calls of 5 chunks (the second from the first's end state); the rrc
sampler with the fleet's polyphase filter (499 taps in steps of 32) and
with a short one (33 taps in steps of 4) over two calls of 4 chunks, so
that its throttled re-shift (one per 33*16 samples) runs again in the
second call, on a carrier whose offset moves freqw. meas_decimation 300,
so nmeas counts are 0, 1 and (never) more.

The JAX side runs in one child process with multiply-add contraction off
(XLA_FLAGS=--xla_cpu_max_isa=AVX), as tests/test_torch_dvbs_rx.py
explains, started by the module's first test that asks for it.

Tolerance: cost, symbol, valid and nmeas equal on every sample and
chunk; the integer state (meas_count, rrc_phase) equal. The float
outputs (sampled, freq, ss, mer) and the float state within rtol 1e-5,
atol 1e-5: XLA rewrites the AGC's 75 / sqrt(est_insp) into 75 *
rsqrt(est_insp), whose CPU rsqrt is not correctly rounded, so agc_gain
differs from the port's IEEE division by an ulp at some chunk ends and
the AGC'd samples (hist_p, sampled, MER's error power) and mu follow
(up to 12 ulps of mu near 0, ROADMAP queue 3). The rrc window's sum is
sequential in tap order on both sides. lookup_float, expi_float and the
tables are equal.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from leansdr_tpu_torch.dsp import receiver as T
from leansdr_tpu_torch.dsp.cstln import Predef, lookup_float
from leansdr_tpu_torch.dsp.cstln import make_dvbs2_constellation
from leansdr_tpu_torch.dsp.math_utils import expi_float
from leansdr_tpu_torch.pipelines.dvbs_rx import RxConfig, rrc_sampler
from leansdr_tpu_torch.util import trace

# Single-threaded torch, as in every port test file.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FMA_OFF = "--xla_cpu_max_isa=AVX"
C = 3
FLEET_RRC = rrc_sampler(4e6, RxConfig(Fs=4e6, Fm=2e6))
SHORT_RRC = (tuple(np.float32(np.hanning(35)[1:-1]
                              / np.hanning(35).sum() * 4).tolist()), 4)
# name: (ReceiverParams fields, chunks per call)
CASES = {f"{s} {'exact' if e else 'computed'}": (
    dict(sampler=s, exact_lut=e) | (dict(rrc_coeffs=FLEET_RRC[0],
                                         rrc_steps=FLEET_RRC[1])
                                    if s == "rrc" else {}), 5)
    for s in ("nearest", "linear", "rrc") for e in (True, False)}
CASES["rrc short exact"] = (dict(sampler="rrc", exact_lut=True,
                                 rrc_coeffs=SHORT_RRC[0],
                                 rrc_steps=SHORT_RRC[1]), 4)
COMMON = dict(omega=2.0, meas_decimation=300)


def _params(mod, fields):
    return mod.ReceiverParams(**COMMON, **fields)


def _stimulus(n, seed=7):
    """[C, n, 2] float32: random QPSK symbols at 2 samples per symbol
    (linear interpolation at a fractional delay per channel), amplitude
    ~75, carrier offsets of 3e-4 * (c - 1) cycles per sample, noise at
    ~20 dB."""
    rng = np.random.default_rng(seed)
    out = []
    for c in range(C):
        nsym = n // 2 + 4
        s = ((rng.integers(0, 2, nsym) * 2 - 1)
             + 1j * (rng.integers(0, 2, nsym) * 2 - 1))
        t = np.arange(n) / 2.0 + 0.15 + 0.3 * c
        z = (np.interp(t, np.arange(nsym), s.real)
             + 1j * np.interp(t, np.arange(nsym), s.imag))
        z = z * np.exp(2j * np.pi * 3e-4 * (c - 1) * np.arange(n)) * 53.0
        z += 5.3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        out.append(np.stack([z.real, z.imag], -1))
    return np.stack(out).astype(np.float32)


def _calls(params, K):
    """The two calls' inputs: chunks [0, K) and [K, 2K), each with the
    sampler's readahead."""
    n = K * T.CHUNK
    x = _stimulus(2 * n + params.readahead)
    return [x[:, :n + params.readahead], x[:, n:2 * n + params.readahead]]


def jax_runs():
    """Every case through the JAX scan (two calls, state carried), and
    the JAX tables, lookup_float and expi_float on fixed inputs."""
    import jax.numpy as jnp
    from leansdr_tpu.dsp import cstln as jc
    from leansdr_tpu.dsp import math_utils as jm
    from leansdr_tpu.dsp import receiver as J
    cst = jc.make_dvbs2_constellation(jc.Predef.QPSK, "1/2")
    tables = J.make_tables(cst)
    out = {"tables": {k: np.asarray(v) for k, v in tables.items()}}
    for name, (fields, K) in CASES.items():
        p = _params(J, fields)
        st = J.init_state(p, C)
        recs = [{k: np.asarray(v) for k, v in st.items()}]
        for x in _calls(p, K):
            st, o = J.run_chunks(p, tables, st, jnp.asarray(x))
            recs.append(dict(out={k: np.asarray(v) for k, v in o.items()},
                             state={k: np.asarray(v) for k, v in st.items()}))
        out[name] = recs
    I, Q = _lookup_inputs()
    out["lookup"] = [np.asarray(v) for v in jc.lookup_float(
        tables["lut_cost"], tables["lut_symbol"], tables["lut_phase"],
        jnp.asarray(I), jnp.asarray(Q))]
    out["expi"] = np.asarray(jm.expi_float(tables["trig"],
                                           jnp.asarray(_expi_inputs())))
    return out


def _lookup_inputs():
    """I, Q over the s8 grid's edges, fractions and overflow up to far
    past the 12 halvings."""
    rng = np.random.default_rng(3)
    v = (rng.standard_normal(40000)
         * np.exp(rng.uniform(-3, 14, 40000))).astype(np.float32)
    edges = np.array([127, 127.5, 128, -128, -128.5, -129, 0, -0.0, 0.99,
                      -0.99, 255.9, -256.1, 3e5, -3e5], np.float32)
    v[:len(edges)] = edges
    v[20000:20000 + len(edges)] = edges[::-1]
    return v[:20000], v[20000:]


def _expi_inputs():
    rng = np.random.default_rng(4)
    return np.concatenate([rng.uniform(-2e5, 2e5, 5000),
                           [0.0, -0.5, 65535.9, 65536.0, -65536.5, 32768.2]]
                          ).astype(np.float32)


@pytest.fixture(scope="module")
def jax(tmp_path_factory):
    """The JAX results, computed in a child process started at the first
    request; call it to wait for them."""
    dst = tmp_path_factory.mktemp("jax_scan_demod") / "out.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {FMA_OFF}",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO), str(REPO / "tests")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    # At a lower priority: the suite's timing-sensitive tests (live
    # pipes) run beside it.
    proc = subprocess.Popen([sys.executable, __file__, str(dst)], env=env,
                            cwd=str(REPO), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT,
                            preexec_fn=lambda: os.nice(10))
    got = {}

    def result():
        if not got:
            log = proc.communicate(timeout=900)[0].decode(errors="replace")
            assert proc.returncode == 0, log[-3000:]
            got.update(pickle.loads(dst.read_bytes()))
        return got
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _tables():
    return T.make_tables(make_dvbs2_constellation(Predef.QPSK, "1/2"), "cpu")


FLOAT_OUT = ("sampled", "freq", "ss", "mer")
EXACT_OUT = ("cost", "symbol", "valid", "nmeas")


def _assert_state(want, got, name):
    assert set(want) == set(got), name
    for k, a in want.items():
        b = got[k].numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, (name, k)
        if a.dtype.kind == "i":
            np.testing.assert_array_equal(b, a, err_msg=f"{name} {k}")
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", list(CASES))
def test_run_chunks_matches_jax(name, jax):
    fields, K = CASES[name]
    p = _params(T, fields)
    tables = _tables()
    st = T.init_state(p, C, "cpu")
    recs = [st]
    for x in _calls(p, K):
        st, o = T.run_chunks(p, tables, st, torch.from_numpy(x))
        recs.append((o, st))
    want = jax()[name]
    _assert_state(want[0], recs[0], f"{name} init_state")
    emitted = 0
    for k, ((o, st), w) in enumerate(zip(recs[1:], want[1:])):
        assert set(o) == set(w["out"]), name
        for key in EXACT_OUT:
            a, b = w["out"][key], o[key].numpy()
            assert a.shape == b.shape and a.dtype == b.dtype, (name, key)
            bad = np.argwhere(a != b)
            assert not len(bad), (f"{name} call {k}: {key} differs at "
                                  f"{bad[0].tolist()}: jax {a[tuple(bad[0])]}"
                                  f" port {b[tuple(bad[0])]}")
        for key in FLOAT_OUT:
            np.testing.assert_allclose(o[key].numpy(), w["out"][key],
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"{name} call {k} {key}")
        _assert_state(w["state"], st, f"{name} call {k}")
        emitted += int(o["valid"].sum())
        assert o["nmeas"].sum() > 0
    assert emitted > C * K * T.CHUNK // 3          # about 1 in 2 samples
    if "short" in name:
        # Re-shifted at chunk 0 and again at chunk 5 (33*16 = 528 samples
        # later): the second call's coefficients follow the new freqw.
        assert int(st["rrc_phase"][0]) == 33 * 16 - 2 * T.CHUNK
        assert not torch.equal(recs[1][1]["rrc_shifted"], st["rrc_shifted"])
    assert trace.counters().get("launch.scan_demod", 0) == 0  # CPU: plain


def test_tables_match_jax(jax):
    want = jax()["tables"]
    got = _tables()
    for k, a in want.items():
        b = got[k].numpy()
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    np.testing.assert_array_equal(got["sym3"].numpy(), np.stack(
        [want["sym_re"], want["sym_im"], want["sym_phase"]]))


def test_lookup_float_and_expi_match_jax(jax):
    """The twelve rounds of overflow halving as one power of 2 from the
    exponent bits give JAX's loop's (I, Q) cell; expi_float truncates,
    then wraps, as JAX's."""
    t = _tables()
    I, Q = _lookup_inputs()
    got = lookup_float(t["lut_cost"], t["lut_symbol"], t["lut_phase"],
                       torch.from_numpy(I), torch.from_numpy(Q))
    for a, b in zip(jax()["lookup"], got):
        np.testing.assert_array_equal(b.numpy(), a)
    np.testing.assert_array_equal(
        expi_float(t["trig"], torch.from_numpy(_expi_inputs())).numpy(),
        jax()["expi"])


def test_agc_gain_is_correctly_rounded():
    """The AGC's 75 / sqrt(est_insp) is the double quotient rounded once to
    float32, at the first chunk end where JAX's differs ("nearest exact",
    call 0, chunk 0, channel 2: est_insp 5604.848, bits 0x45af26c9; the
    double quotient 1.0017961034606753 rounds to 1.00179613, the port's;
    JAX's 1.00179601 is the float below it, from XLA:CPU's rewrite into a
    multiply by an rsqrt that is not correctly rounded). No JAX here."""
    fields, K = CASES["nearest exact"]
    p = _params(T, fields)
    x = np.ascontiguousarray(_calls(p, K)[0][:, :T.CHUNK + p.readahead])
    st, _ = T.run_chunks(p, _tables(), T.init_state(p, C, "cpu"),
                         torch.from_numpy(x))
    e = st["est_insp"].numpy()
    want = (75.0 / np.sqrt(e.astype(np.float64))).astype(np.float32)
    np.testing.assert_array_equal(st["agc_gain"].numpy(), want)
    assert e[2].view(np.uint32) == 0x45AF26C9
    assert st["agc_gain"][2].item() == np.float32(1.00179613)


def test_scan_kernel_build_geometry():
    """The kernel's launch geometry the wrapper checks on the CPU side:
    the staged input ring for the rrc readahead fits the shared memory
    (the fleet's 16 taps, 2.4 Msps' 10), and the per-kernel nvcc flags
    keep IEEE arithmetic (no contraction, no fast math)."""
    from leansdr_tpu_torch import device
    for fs in (4e6, 2.4e6):
        co, steps = rrc_sampler(fs, RxConfig(Fs=fs, Fm=2e6))
        p = T.ReceiverParams(omega=fs / 2e6, sampler="rrc", rrc_coeffs=co,
                             rrc_steps=steps)
        assert T.smem_bytes(p, 4) <= T.SMEM_LIMIT
        assert p.readahead == {4e6: 16, 2.4e6: 10}[fs]
    assert device.KERNEL_FLAGS["scan_demod"] == ["--fmad=false"]
    assert device.KERNEL_FLAGS["hs_demod"] == ["--fmad=false"]
    with pytest.raises(ValueError, match="multiple"):
        T.run_chunks(_params(T, dict(sampler="linear")), _tables(),
                     T.init_state(_params(T, {}), 1, "cpu"),
                     torch.zeros((1, 130, 2)))


if __name__ == "__main__":
    # The JAX side: python test_torch_scan_demod.py OUT.pkl
    Path(sys.argv[1]).write_bytes(pickle.dumps(jax_runs()))
