"""The port's candidate scan against the JAX package's: per-channel omega
in the scan demod (leansdr_tpu_torch.dsp.receiver: per_channel_omega_state,
run_chunks_ref, the plain version of csrc/scan_demod.cu's per-channel
mode), the candidate-scan receiver (pipelines/scan_rx.py) and the
`leansdrscan --device` CLI (apps/leansdrscan.py).

Cases:
  per_channel_omega_state  JAX's float32 NumPy formulas at the reference
      grid's omegas (4 SR at 2.4 Msps), QPSK and 8PSK, freq0 and
      pll_adjustment set: every array equal, dtype and all.
  run_chunks  per-channel mode at C=3 with omegas 2.0, 2.5 and 3.0 (each
      channel carries QPSK at its own rate), every sampler (nearest,
      linear, rrc with the fleet's 499 taps in steps of 32) x decision
      mode (exact LUT, computed), two calls of 2 chunks.
  CandidateScanReceiver  a 2 SR x 2 CR grid (1 and 2 Msym/s x 1/2 and
      7/8) at 2.4 Msps (the rtl_sdr rate: 1.2 samples per symbol, the
      fold-back front end of tests/test_torch_exact_rx.py) on 9 reads of
      2048 samples of a 2 Msym/s rate-7/8 carrier (an offset of 1e-4
      cycles per sample), the 9th the first with a packet out, then
      focus() on the winner and one more read of 2048.
  leansdrscan --device  live (no --rewind) with `--device cpu` in the
      template, on 28672 samples of the same carrier (the CLI reads 65536
      samples at a time, and in one read the chain needs ~25k to put out
      a packet): it elects (2e6, 7/8) and writes sent packets; --rewind
      with a stand-in program in the template that
      prints its argv and the bytes it reads, so the exec'd command gets
      the elected --sr/--cr and the whole file, and the capture is
      decoded once.

The JAX side runs in one child process with multiply-add contraction off
(XLA_FLAGS=--xla_cpu_max_isa=AVX), as tests/test_torch_dvbs_rx.py
explains; the two CLI runs start as child processes with it.

Tolerance: the demod's integer outputs (cost, symbol, valid, nmeas) and
integer state equal, its float outputs and state within
tests/test_torch_scan_demod.py's bars (rtol 1e-5, atol 1e-5: XLA's AGC
rsqrt, ROADMAP queue 3); the per-channel entries equal. The scan
receiver: every call's winner, every candidate's TS bytes, the integer
and per-channel state entries equal; the float state of the carrier's
group (2 Msym/s, the one that locks) within the same bars, before and
after focus(). The other group's float state is not compared: a loop
at a symbol rate the signal does not have never locks, and it amplifies
the ulp differences of XLA's rsqrt, cos and sin (seen: equal to 2e-7
for 5 reads, then hist_p 2.6 relative apart 3 reads later); its
candidates put out no packet on either side.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.signal import resample_poly

from leansdr_tpu_torch.dsp import receiver as T
from leansdr_tpu_torch.dsp.cstln import Predef, make_dvbs2_constellation
from leansdr_tpu_torch.fec import prbs
from leansdr_tpu_torch.pipelines import dvbs_tx, tsgen
from leansdr_tpu_torch.pipelines.dvbs_rx import RxConfig, rrc_sampler
from leansdr_tpu_torch.pipelines.scan_rx import CandidateScanReceiver
from leansdr_tpu_torch.util.iofmt import write_iq
from leansdr_tpu_torch.util import trace

# Single-threaded torch, as in every port test file.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FMA_OFF = "--xla_cpu_max_isa=AVX"
C = 3
OMEGAS = (2.0, 2.5, 3.0)
FLEET_RRC = rrc_sampler(4e6, RxConfig(Fs=4e6, Fm=2e6))
MODES = {f"{s} {'exact' if e else 'computed'}": dict(
    sampler=s, exact_lut=e) | (dict(rrc_coeffs=FLEET_RRC[0],
                                    rrc_steps=FLEET_RRC[1])
                               if s == "rrc" else {})
    for s in ("nearest", "linear", "rrc") for e in (True, False)}
K = 2                                   # chunks per call
# per_channel_omega_state cases: (ReceiverParams fields, omegas)
GRID_OMEGAS = [2.4e6 / sr for sr in (250e3, 333e3, 1e6, 2e6)]
STATE_CASES = [
    (dict(omega=2.0), GRID_OMEGAS),
    (dict(omega=2.0, nsymbols=8, freq0=0.01, pll_adjustment=2.0),
     GRID_OMEGAS),
    (dict(omega=2.0, nsymbols=32), (1.2, 3.7, 64.5)),
]
# The scan receiver's grid and reads.
FS = 2.4e6
SRS, CRS = (1e6, 2e6), ("1/2", "7/8")
READS = (2048,) * 9
AFTER_FOCUS = 2048
CLI_SAMPLES = 28672
STAND_IN = "import sys;print(sys.argv[1:]);print(len(sys.stdin.buffer.read()))"


def _params(mod, fields):
    return mod.ReceiverParams(omega=2.0, meas_decimation=300,
                              omega_per_channel=True, **fields)


def _demod_stimulus(n, seed=11):
    """[C, n, 2] float32: channel c carries random QPSK symbols at
    OMEGAS[c] samples per symbol (linear interpolation at a fractional
    delay), amplitude ~75, an offset of 3e-4 * (c - 1) cycles per
    sample, noise at ~20 dB."""
    rng = np.random.default_rng(seed)
    out = []
    for c, om in enumerate(OMEGAS):
        nsym = int(n / om) + 4
        s = ((rng.integers(0, 2, nsym) * 2 - 1)
             + 1j * (rng.integers(0, 2, nsym) * 2 - 1))
        t = np.arange(n) / om + 0.15 + 0.3 * c
        z = (np.interp(t, np.arange(nsym), s.real)
             + 1j * np.interp(t, np.arange(nsym), s.imag))
        z = z * np.exp(2j * np.pi * 3e-4 * (c - 1) * np.arange(n)) * 53.0
        z += 5.3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        out.append(np.stack([z.real, z.imag], -1))
    return np.stack(out).astype(np.float32)


def _calls(params):
    n = K * T.CHUNK
    x = _demod_stimulus(2 * n + params.readahead)
    return [x[:, :n + params.readahead], x[:, n:2 * n + params.readahead]]


def _capture(n=sum(READS) + AFTER_FOCUS):
    """[n, 2] float32 at unit amplitude: a 2 Msym/s rate-7/8 QPSK carrier
    (the port's modulator at 2 samples per symbol, up 6, every 10th
    sample from the 3rd: 2.4 Msps with a fractional delay), shifted by
    1e-4 cycles per sample."""
    iq = dvbs_tx.modulate(tsgen.generate(60),
                          dvbs_tx.TxConfig(rate="7/8", interp=2))
    z = resample_poly(iq[:, 0] + 1j * iq[:, 1], 6, 1)[3::10][:n]
    assert len(z) == n
    z = z * np.exp(2j * np.pi * 1e-4 * np.arange(n))
    return np.stack([z.real, z.imag], -1).astype(np.float32)


def _sent(pkts) -> list:
    """The numbers of the sent packets that `pkts` are, in order; raises
    unless each is one, up to the derandomizer's PRBS phase: until its
    first resync (an inverted sync byte, one packet in 8) a chain
    XORs the pattern of another phase (the reference's derandomizer
    alike), so a packet is held equal to a sent one XOR the patterns of
    two phases."""
    sent = tsgen.generate(60)
    pat = prbs.prbs_pattern().reshape(8, 188)
    turns = {(pat[a] ^ pat[b])[1:].tobytes() for a in range(8)
             for b in range(8)}
    nums = []
    for p in pkts:
        hit = [i for i, q in enumerate(sent)
               if (p[1:] ^ q[1:]).tobytes() in turns]
        assert p[0] == 0x47 and hit, p[:8]
        nums.append(hit[0])
    assert nums == list(range(nums[0], nums[0] + len(nums))), nums
    return nums


def _np_state(st):
    return {k: np.array(v) for k, v in st.items()}


def _scan_runs(make, np_of):
    """Drive a scan receiver (make() builds it) over READS, focus() on
    the winner, one more read. Returns its record."""
    x = _capture()
    rx = make()
    rec = dict(states=[], winners=[])
    o = 0
    for n in READS:
        rec["winners"].append(rx.process(x[o:o + n]))
        rec["states"].append(np_of(rx.state))
        o += n
    rec["outputs"] = [np.array(v) for v in rx.outputs]
    w = rx.winner()
    rx.focus(w)
    rec["focused"] = np_of(rx.state)
    rx.process(x[o:o + AFTER_FOCUS])
    rec["after"] = np_of(rx.state)
    rec["after_out"] = np.array(rx.outputs[0])
    rec["group_fms"] = list(rx.group_fms)
    return rec


def jax_runs():
    """Every case through the JAX package."""
    import jax.numpy as jnp
    from leansdr_tpu.dsp import cstln as jc
    from leansdr_tpu.dsp import receiver as J
    from leansdr_tpu.pipelines.scan_rx import CandidateScanReceiver as JS
    out = {"states": [_np_state(J.per_channel_omega_state(
        J.ReceiverParams(**f), om)) for f, om in STATE_CASES]}
    tables = J.make_tables(jc.make_dvbs2_constellation(jc.Predef.QPSK,
                                                       "1/2"))
    for name, fields in MODES.items():
        p = _params(J, fields)
        st = J.init_state(p, C)
        st.update(J.per_channel_omega_state(p, np.array(OMEGAS, np.float32)))
        recs = [_np_state(st)]
        for x in _calls(p):
            st, o = J.run_chunks(p, tables, st, jnp.asarray(x))
            recs.append(dict(out=_np_state(o), state=_np_state(st)))
        out[name] = recs
    out["scan"] = _scan_runs(
        lambda: JS.grid(FS, SRS, CRS, float_scale=75.0), _np_state)
    return out


def _child(args, dst_env=None, **kw):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO), str(REPO / "tests")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    env.update(dst_env or {})
    # At a lower priority: the suite's timing-sensitive tests (live
    # pipes) run beside it.
    return subprocess.Popen(args, env=env, cwd=str(REPO),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            preexec_fn=lambda: os.nice(10), **kw)


@pytest.fixture(scope="module")
def jax(tmp_path_factory):
    """The JAX results, computed in a child process started at the first
    request; call it to wait for them."""
    dst = tmp_path_factory.mktemp("jax_scan_rx") / "out.pkl"
    proc = _child([sys.executable, __file__, str(dst)],
                  {"XLA_FLAGS": f"{os.environ.get('XLA_FLAGS', '')} "
                                f"{FMA_OFF}"})
    got = {}

    def result():
        if not got:
            _, err = proc.communicate(timeout=900)
            assert proc.returncode == 0, err.decode(errors="replace")[-3000:]
            got.update(pickle.loads(dst.read_bytes()))
        return got
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _template(prog):
    return prog + ["--device", "cpu", "--f32", "--float-scale", "75",
                   "-f", f"{FS:g}", "--sr", ",".join(f"{v:g}" for v in SRS),
                   "--cr", ",".join(CRS), "--fastlock"]


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """The port's `leansdrscan --device` on the capture (f32, a file on
    stdin), live and with --rewind and the stand-in program, started at
    the first request as child processes; call it to wait for
    {"live": (rc, stdout, stderr), "rewind": ...}."""
    path = tmp_path_factory.mktemp("scan_cli") / "capture.f32"
    path.write_bytes(write_iq(_capture(CLI_SAMPLES), "f32"))
    scan = [sys.executable, "-m", "leansdr_tpu_torch.apps.leansdrscan",
            "--device", "-t", "600"]
    runs = {}
    for name, extra, prog in (
            ("live", [], [sys.executable, "-m",
                          "leansdr_tpu_torch.apps.leandvb"]),
            ("rewind", ["--rewind"], [sys.executable, "-c", STAND_IN])):
        with open(path, "rb") as f:
            runs[name] = _child(scan + extra + _template(prog), stdin=f)
    got = {}

    def result():
        if not got:
            for name, p in runs.items():
                o, e = p.communicate(timeout=900)
                got[name] = (p.returncode, o, e.decode(errors="replace"))
        return got
    yield result
    for p in runs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


def test_candidate_scan_receiver_matches_jax(jax, cli):
    """Every read's winner, state and the candidates' TS bytes equal to
    the JAX receiver's; the winner is the carrier's (2e6, 7/8), whose
    packets are sent ones; focus() keeps its group's state (the
    per-channel entries too) and decodes on."""
    rec = _scan_runs(lambda: CandidateScanReceiver.grid(
        FS, SRS, CRS, float_scale=75.0, device="cpu"), _np_state)
    want = jax()["scan"]
    assert rec["winners"] == want["winners"]
    win = rec["winners"][-1]
    assert win == SRS.index(2e6) * len(CRS) + CRS.index("7/8")
    g = SRS.index(2e6)                  # the carrier's group
    for k, (a, b) in enumerate(zip(want["states"], rec["states"])):
        _assert_state(a, b, f"read {k}", slice(g, g + 1))
    assert len(rec["outputs"]) == len(want["outputs"]) == 4
    for a, b in zip(want["outputs"], rec["outputs"]):
        np.testing.assert_array_equal(b, a)
    assert all(not len(v) for c, v in enumerate(rec["outputs"]) if c != win)
    _assert_state(want["focused"], rec["focused"], "focused")
    assert rec["focused"]["omega"].tolist() == [np.float32(FS / 2e6)]
    assert rec["group_fms"] == want["group_fms"] == [2e6]
    _assert_state(want["after"], rec["after"], "after focus")
    np.testing.assert_array_equal(rec["after_out"], want["after_out"])
    # The focused chain kept its output and added the next packets.
    assert len(_sent(rec["after_out"])) > len(rec["outputs"][win])


def test_per_channel_omega_state_matches_jax(jax):
    """Every array of per_channel_omega_state equal to JAX's (float32
    NumPy arithmetic on float32 omegas, not the static mode's roundings
    from double), and init_state's entries at params.omega."""
    for (fields, om), want in zip(STATE_CASES, jax()["states"]):
        got = T.per_channel_omega_state(T.ReceiverParams(**fields), om,
                                        "cpu")
        assert list(got) == list(T.PER_CHANNEL) == list(want)
        for k, a in want.items():
            b = got[k].numpy()
            assert b.dtype == a.dtype == np.float32, k
            np.testing.assert_array_equal(b, a, err_msg=k)
    p = _params(T, {})
    st = T.init_state(p, 2, "cpu")
    assert st["omega"].tolist() == [2.0, 2.0]
    assert st["freq_beta"].tolist() == [np.float32(0.0006)] * 2


def _assert_state(want, got, name, float_chans=slice(None)):
    """Integer and per-channel entries equal; float entries of the
    channels `float_chans` within rtol 1e-5, atol 1e-5."""
    assert set(want) == set(got), (name, set(want) ^ set(got))
    for k, a in want.items():
        b = np.array(got[k])
        assert a.shape == b.shape and a.dtype == b.dtype, (name, k)
        if a.dtype.kind in "iub" or k in T.PER_CHANNEL:
            np.testing.assert_array_equal(b, a, err_msg=f"{name} {k}")
        else:
            np.testing.assert_allclose(b[float_chans], a[float_chans],
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", list(MODES))
def test_run_chunks_per_channel_matches_jax(name, jax):
    p = _params(T, MODES[name])
    tables = T.make_tables(make_dvbs2_constellation(Predef.QPSK, "1/2"),
                           "cpu")
    st = T.init_state(p, C, "cpu")
    st.update(T.per_channel_omega_state(p, OMEGAS, "cpu"))
    want = jax()[name]
    _assert_state(want[0], _np_state(st), f"{name} init")
    emitted = np.zeros(C)
    for k, (x, w) in enumerate(zip(_calls(p), want[1:])):
        st, o = T.run_chunks(p, tables, st, torch.from_numpy(x))
        for key in ("cost", "symbol", "valid", "nmeas"):
            np.testing.assert_array_equal(o[key].numpy(), w["out"][key],
                                          err_msg=f"{name} call {k} {key}")
        for key in ("sampled", "freq", "ss", "mer"):
            np.testing.assert_allclose(o[key].numpy(), w["out"][key],
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"{name} call {k} {key}")
        _assert_state(w["state"], _np_state(st), f"{name} call {k}")
        emitted += o["valid"].numpy().sum(1)
    # Each channel emits at its own rate: about 1 in omega samples.
    n = 2 * K * T.CHUNK
    np.testing.assert_allclose(emitted, n / np.array(OMEGAS), rtol=0.1)
    assert trace.counters().get("launch.scan_demod", 0) == 0  # CPU: plain


def test_leansdrscan_device_live_cpu(cli):
    """`leansdrscan --device` with `--device cpu` in the template elects
    (2e6, 7/8) in process, continues there, and writes sent packets."""
    rc, out, err = cli()["live"]
    assert rc == 0, err[-2000:]
    assert "Device scan elected: --sr 2e+06 --cr 7/8" in err, err[-2000:]
    assert "continuing in-process" in err
    ts = np.frombuffer(out, np.uint8)
    assert len(ts) % 188 == 0
    assert len(_sent(ts.reshape(-1, 188))) >= 3


def test_leansdrscan_device_rewind_execs_winner(cli):
    """With --rewind the elected command is exec'd with --sr 2e+06 --cr
    7/8 in place of the sweeps and the whole capture on its stdin."""
    rc, out, err = cli()["rewind"]
    assert rc == 0, err[-2000:]
    assert "exec: " in err, err[-2000:]
    argv, nbytes = out.decode().splitlines()
    want = _template([])
    want[want.index("--sr") + 1] = "2e+06"
    want[want.index("--cr") + 1] = "7/8"
    assert argv == repr(want)
    assert int(nbytes) == CLI_SAMPLES * 8


if __name__ == "__main__":
    # The JAX side: python test_torch_scan_rx.py OUT.pkl
    Path(sys.argv[1]).write_bytes(pickle.dumps(jax_runs()))
