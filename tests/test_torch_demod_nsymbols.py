"""The port's two demods at every constellation size the DVB-S CLIs take
(BPSK, 8PSK, 16APSK, 32APSK, 64APSKe: nsymbols 2, 8, 16, 32, 64),
against the JAX package's scan demod (leansdr_tpu.dsp.receiver.run_chunks,
use_pallas=False, its CPU route):

  * the demod kernel's plain version (dsp/receiver_kernel.demod_ref,
    computed decisions, 8-bit symbols) against the JAX scan with
    computed decisions;
  * the scan demod's plain version (dsp/receiver.run_chunks_ref, the
    csrc/scan_demod.cu twin) with the exact LUT and with computed
    decisions against the JAX scan in the same mode;

each on C=2 lanes, 2 samples per symbol with fractional delays, carrier
offsets and noise, over 4 chunks. The fleet and the single carrier call
the same functions, at C carriers and at C=1 (one JAX compilation per
lane count and mode, so one lane count here; tests/
test_torch_constellations.py runs 8PSK end to end on one carrier).
The JAX side runs in one child process with multiply-add contraction off
(XLA_FLAGS=--xla_cpu_max_isa=AVX), as tests/test_torch_dvbs_rx.py
explains.

Tolerance: valid flags equal on every sample; symbol and cost equal on
every valid sample (non-emitted samples carry a discarded decision).
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
from leansdr_tpu_torch.dsp import receiver_kernel as rk
from leansdr_tpu_torch.dsp.cstln import Predef, make_dvbs2_constellation

# Single-threaded torch, as in every port test file.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FMA_OFF = "--xla_cpu_max_isa=AVX"
# (constellation, a rate it takes)
CONSTS = (("BPSK", "1/2"), ("PSK8", "2/3"), ("APSK16", "3/4"),
          ("APSK32", "4/5"), ("APSK64E", "4/6"))
NCHUNKS = 4
COMMON = dict(omega=2.0, sampler="linear", meas_decimation=300,
              pll_adjustment=1.0 / 6)


def _stimulus(name, rate, C, seed):
    """[C, n + 1, 2] float32: random symbols of the constellation at its
    own amplitude, 2 samples per symbol linearly interpolated at a
    fractional delay per lane, carrier offsets, noise ~25 dB down."""
    cst = make_dvbs2_constellation(Predef[name], rate)
    pts = cst.symbols[:, 0] + 1j * cst.symbols[:, 1]
    rng = np.random.default_rng(seed)
    n = NCHUNKS * T.CHUNK + 1
    out = []
    for c in range(C):
        s = pts[rng.integers(0, cst.nsymbols, n // 2 + 4)]
        t = np.arange(n) / 2.0 + 0.2 + 0.25 * c
        z = (np.interp(t, np.arange(len(s)), s.real)
             + 1j * np.interp(t, np.arange(len(s)), s.imag))
        z = z * np.exp(2j * np.pi * 2e-4 * (c - 1) * np.arange(n))
        z += 0.04 * np.abs(pts).max() * (rng.standard_normal(n)
                                         + 1j * rng.standard_normal(n))
        out.append(np.stack([z.real, z.imag], -1))
    return np.stack(out).astype(np.float32)


def _cases():
    for name, rate in CONSTS:
        yield name, rate, 2


def jax_runs():
    """The JAX scan, computed and exact, on every case (child process)."""
    import jax.numpy as jnp
    from leansdr_tpu.dsp import cstln as jc
    from leansdr_tpu.dsp import receiver as J
    out = {}
    for name, rate, C in _cases():
        cst = jc.make_dvbs2_constellation(jc.Predef[name], rate)
        tables = J.make_tables(cst)
        x = jnp.asarray(_stimulus(name, rate, C, seed=C))
        for exact in (False, True):
            p = J.ReceiverParams(**COMMON, nsymbols=cst.nsymbols,
                                 exact_lut=exact)
            _, o = J.run_chunks(p, tables, J.init_state(p, C), x)
            out[(name, C, exact)] = {k: np.asarray(o[k]) for k in
                                     ("symbol", "valid", "cost")}
    return out


@pytest.fixture(scope="module")
def jax(tmp_path_factory):
    dst = tmp_path_factory.mktemp("jax_nsym") / "out.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {FMA_OFF}",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    proc = subprocess.Popen([sys.executable, __file__, str(dst)], env=env,
                            cwd=str(REPO), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
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


def _same(want, sym, valid, cost, what):
    np.testing.assert_array_equal(want["valid"], valid, err_msg=what)
    v = want["valid"]
    assert v.sum() > v.size // 3, what                 # ~1 in 2 samples
    np.testing.assert_array_equal(want["symbol"][v], sym[v], err_msg=what)
    np.testing.assert_array_equal(want["cost"][v], cost[v], err_msg=what)


@pytest.mark.parametrize("name,rate,C", list(_cases()))
def test_demods_match_jax_scan(name, rate, C, jax):
    """demod_ref (computed) and run_chunks_ref (computed and exact LUT)
    against the JAX scan on the same lanes: valid, symbol and cost."""
    cst = make_dvbs2_constellation(Predef[name], rate)
    x = torch.from_numpy(_stimulus(name, rate, C, seed=C))
    want = jax()
    p = T.ReceiverParams(**COMMON, nsymbols=cst.nsymbols, exact_lut=False)
    planes = rk.pack_state(T.init_state(p, C, "cpu"))
    _, packed = rk.demod(p, rk.sym_constants(cst), planes, x)
    pk = packed.numpy().T                                  # [C, n]
    w = want[(name, C, False)]
    _same(w, ((pk >> 16) & 0xFF).astype(np.uint8),
          ((pk >> 24) & 1).astype(bool), (-(pk & 0xFFFF)).astype(np.int16),
          f"{name} C={C} demod kernel")
    syms = set(np.unique(w["symbol"][w["valid"]]).tolist())
    assert max(syms) < cst.nsymbols and len(syms) > cst.nsymbols // 2
    tables = T.make_tables(cst, "cpu")
    for exact in (False, True):
        p = T.ReceiverParams(**COMMON, nsymbols=cst.nsymbols,
                             exact_lut=exact)
        _, o = T.run_chunks(p, tables, T.init_state(p, C, "cpu"), x)
        _same(want[(name, C, exact)], o["symbol"].numpy(),
              o["valid"].numpy(), o["cost"].numpy(),
              f"{name} C={C} scan exact={exact}")


if __name__ == "__main__":          # the JAX side (child process)
    sys.path.insert(0, str(REPO))
    Path(sys.argv[1]).write_bytes(pickle.dumps(jax_runs()))
