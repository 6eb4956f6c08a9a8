"""The port's device modulator (leansdr_tpu_torch.pipelines.dvbs_tx_device)
against the JAX package's, on the CPU.

Cases: QPSK at rates 1/2, 3/4 and 7/8 and 8PSK at 2/3 (interp 2), on 30
numbered TS packets:
  - the constellation symbols equal the JAX host chain's
    (leansdr_tpu.pipelines.dvbs_tx's randomizer, RS encoder, interleaver
    and convolutional encoder; the JAX device chain does not return
    them);
  - the IQ equals JAX's DeviceModulator.modulate bit for bit: the RS
    parity is a float32 matmul of 0/1 planes (sums at most 1504, exact),
    the other stages integer, and the polyphase RRC sums acc + c * x tap
    by tap in JAX's order, one rounding per operation on both sides (the
    JAX side runs with multiply-add contraction off,
    XLA_FLAGS=--xla_cpu_max_isa=AVX, in one child process, as
    tests/test_torch_dvbs_rx.py explains);
  - after the RRC latency the IQ is within 1e-5 of the port's host
    modulator (tests/test_tx_golden.py's alignment and bar: the host sums
    the FIR by np.convolve, in another order);
  - rs.gf2_encode_matrix equals JAX's;
  - device_stimulus gives the same IQ at amp 75, and raises where the
    device chain fails, with no fallback to the host modulator.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from leansdr_tpu_torch.dsp.cstln import Predef
from leansdr_tpu_torch.fec import rs
from leansdr_tpu_torch.pipelines import dvbs_tx, dvbs_tx_device, tsgen

# Single-threaded torch, as in every port test file.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FMA_OFF = "--xla_cpu_max_isa=AVX"
CASES = [("QPSK", "1/2"), ("QPSK", "3/4"), ("QPSK", "7/8"), ("PSK8", "2/3")]
NPKT = 30


def _packets():
    return tsgen.generate(NPKT, start=1000)


def jax_runs():
    """Every case through the JAX device modulator, the JAX host chain's
    symbols, and JAX's encode matrix."""
    from leansdr_tpu.dsp.cstln import Predef as JP
    from leansdr_tpu.dsp.cstln import make_dvbs2_constellation
    from leansdr_tpu.fec import convenc, interleave, prbs
    from leansdr_tpu.fec import rs as jrs
    from leansdr_tpu.pipelines.dvbs_tx_device import (DeviceModulator,
                                                      device_stimulus)
    pk = _packets()
    out = {"enc_m": jrs.gf2_encode_matrix()}
    for c, r in CASES:
        mod = DeviceModulator(JP[c], r, interp=2)
        # The host chain up to the symbols (leansdr_tpu/pipelines/
        # dvbs_tx.py:modulate), at the rate the modulator runs.
        bps = make_dvbs2_constellation(JP[c], r).bits_per_symbol
        rand, _ = prbs.randomize(pk, 0)
        ilv, _ = interleave.interleave(jrs.encode(rand))
        bits_in, _ = convenc.FEC_SPECS[mod.rate]
        sym, _ = convenc.encode(ilv[: len(ilv) // bits_in * bits_in],
                                mod.rate, bps)
        out[(c, r)] = dict(iq=mod.modulate(pk), symbols=np.asarray(sym),
                           rate=mod.rate, ncoeffs=mod.ncoeffs)
    out["stimulus"] = np.asarray(device_stimulus(pk, "3/4", 2, 75.0))
    return out


@pytest.fixture(scope="module")
def jax(tmp_path_factory):
    """The JAX results, computed in a child process started at the first
    request; call it to wait for them."""
    dst = tmp_path_factory.mktemp("jax_tx_device") / "out.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {FMA_OFF}",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO), str(REPO / "tests")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
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


def test_gf2_encode_matrix_matches_jax(jax):
    m = rs.gf2_encode_matrix()
    assert m.shape == (188 * 8, 16 * 8) and m.dtype == np.int8
    np.testing.assert_array_equal(m, jax()["enc_m"])


@pytest.mark.parametrize("case", CASES, ids=" ".join)
def test_device_modulator_matches_jax(case, jax):
    c, r = case
    mod = dvbs_tx_device.DeviceModulator(Predef[c], r, interp=2,
                                         device="cpu")
    want = jax()[case]
    assert (mod.rate, mod.ncoeffs) == (want["rate"], want["ncoeffs"])
    assert mod.rate == ("4/6" if case == ("QPSK", "2/3") else r)
    pk = _packets()
    sym = mod.symbols(torch.from_numpy(pk)).numpy()
    np.testing.assert_array_equal(sym, want["symbols"])
    iq = mod.modulate(pk)
    assert iq.dtype == np.float32 and iq.shape == want["iq"].shape
    np.testing.assert_array_equal(iq, want["iq"])
    # Against the port's host modulator after the RRC latency.
    host = dvbs_tx.modulate(pk, dvbs_tx.TxConfig(
        constellation=Predef[c], rate=r, interp=2))
    latency = (mod.ncoeffs + 2) // 2
    seg = iq[latency * 2: latency * 2 + len(host)]
    assert len(seg) == len(host)
    assert np.abs(host - seg).max() < 1e-5


def test_device_stimulus_matches_jax_and_raises(jax, monkeypatch):
    y = dvbs_tx_device.device_stimulus(_packets(), "3/4", 2, 75.0,
                                       device="cpu")
    assert torch.is_tensor(y) and y.device.type == "cpu"
    np.testing.assert_array_equal(y.numpy(), jax()["stimulus"])

    def broken(self, packets):
        raise RuntimeError("device TX failed")
    monkeypatch.setattr(dvbs_tx_device.DeviceModulator, "modulate_tensor",
                        broken)
    with pytest.raises(RuntimeError, match="device TX failed"):
        dvbs_tx_device.device_stimulus(_packets(), device="cpu")
    with pytest.raises(ValueError, match="interleaver needs 12"):
        dvbs_tx_device.DeviceModulator(device="cpu").symbols(
            torch.from_numpy(tsgen.generate(11)))


if __name__ == "__main__":
    # The JAX side: python test_torch_tx_device.py OUT.pkl
    Path(sys.argv[1]).write_bytes(pickle.dumps(jax_runs()))
