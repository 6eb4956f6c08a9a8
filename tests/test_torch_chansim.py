"""The port's channel simulator and --awgn against the JAX package:
leansdr_tpu_torch.pipelines.chansim (drand48, wgn_c, drifter, simulate),
the leanchansim CLI, DvbsReceiver(awgn=...)'s noise stage, a short
receiver run with --awgn, and a JAX --awgn checkpoint resumed in the
port.

Tolerance: none for the host stages (NumPy in both packages): noise,
drift, simulate, CLI bytes, `_preprocess` output and `noise_draws` are
equal. The receiver run holds the demod's valid flags, symbols and soft
costs, the decoder's bytes, the TS and the backlogs exactly, and the
demod's float state to test_torch_dvbs_rx.py's bar (max(1e-3,
1e-4*|v|), phase modulo one turn). The JAX receiver runs its Pallas
demod in interpret mode in a child process with multiply-add contraction
off, as test_torch_dvbs_rx.py sets out.
"""

import io
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from leansdr_tpu.apps import leanchansim as jcli
from leansdr_tpu.pipelines import chansim as J
from leansdr_tpu.pipelines import dvbs_rx as JR

from leansdr_tpu_torch.apps import leanchansim as tcli
from leansdr_tpu_torch.convert import from_jax_dvbs_checkpoint
from leansdr_tpu_torch.dsp import receiver_kernel as rk
from leansdr_tpu_torch.pipelines import chansim as T
from leansdr_tpu_torch.pipelines import dvbs_rx as TR
from leansdr_tpu_torch.pipelines import dvbs_tx, tsgen

# Single-threaded torch, as in every port test file.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FMA_OFF = "--xla_cpu_max_isa=AVX"
SEEDS = (J.DRAND48_DEFAULT_SEED, (12345 << 16) | 0x330E, (1 << 48) - 1)


@pytest.mark.parametrize("seed", SEEDS)
def test_drand48_matches_jax(seed):
    for n in (0, 1, 2, 1000, 4097):
        np.testing.assert_array_equal(T.drand48_sequence(n, seed),
                                      J.drand48_sequence(n, seed))
    for k in (0, 1, 1000, 123457):
        assert T.drand48_jump(k, seed) == J.drand48_jump(k, seed)
    # The jump continues the sequence.
    s = T.drand48_sequence(1001, seed)
    assert T.drand48_sequence(1, T.drand48_jump(1000, seed))[0] == s[1000]


def test_wgn_c_split_reads_match_jax():
    """wgn_c over reads of uneven sizes, each continuing the drand48
    stream by its draw count, equals one whole call (and JAX's)."""
    whole, used = J.wgn_c(7001, 0.3)
    got, draws = [], 0
    for n in (1, 999, 3000, 2001, 1000):
        w, u = T.wgn_c(n, 0.3, seed=T.drand48_jump(draws))
        jw, ju = J.wgn_c(n, 0.3, seed=J.drand48_jump(draws))
        np.testing.assert_array_equal(w, jw)
        assert u == ju
        got.append(w)
        draws += u
    np.testing.assert_array_equal(np.concatenate(got), whole)
    assert draws == used
    assert whole.dtype == np.float32 and whole.shape == (7001, 2)


def _iq(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 2)).astype(np.float32)


def test_drifter_and_simulate_match_jax():
    x = _iq(20000)
    drifts = (T.DriftComponent(amp=3e-4, freq=1e-4),
              T.DriftComponent(amp=1e-4, freq=7e-6), T.DriftComponent())
    jdrifts = tuple(J.DriftComponent(d.amp, d.freq) for d in drifts)
    np.testing.assert_array_equal(T.drifter(x, drifts),
                                  J.drifter(x, jdrifts))
    np.testing.assert_array_equal(T.drifter(x, (T.DriftComponent(),) * 3),
                                  x)
    for kw in (dict(scale=2.5, awgn=0.1, deterministic=True),
               dict(scale=0.5, awgn=0.2, seed=4242),
               dict(scale=1.0, awgn=0.0)):
        want = J.simulate(x, J.ChansimConfig(drifts=jdrifts, **kw))
        got = T.simulate(x, T.ChansimConfig(drifts=drifts, **kw))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.float32


def _main(main, argv, stdin: bytes, monkeypatch, tmp_path):
    """main(argv) in this process with `stdin` as its standard input;
    returns (exit code, stdout bytes, stderr text)."""
    src = tmp_path / "stdin.bin"
    src.write_bytes(stdin)
    out, err = io.BytesIO(), io.StringIO()
    with open(src, "rb") as f:
        monkeypatch.setattr(sys, "stdin", type("In", (), {"buffer": f}))
        monkeypatch.setattr(sys, "stdout", type("Out", (), {"buffer": out}))
        monkeypatch.setattr(sys, "stderr", err)
        rc = main(list(argv))
    monkeypatch.undo()
    return rc, out.getvalue(), err.getvalue()


CHANSIM_ARGV = [
    ["--if32", "--of32", "--awgn", "-14", "--deterministic"],
    ["--if32", "--ou8", "--awgn", "-14", "--deterministic", "--scale",
     "30"],
    ["--iu8", "--of32", "--awgn", "-20", "--deterministic", "-f", "2.4e6",
     "--lo", "10e9", "--ppm", "0.5", "--drift-period", "0.01",
     "--drift2-amp", "2e3", "--drift2-freq", "50"],
    ["--iu8", "--ou8", "--awgn", "-30", "--deterministic", "-f", "1e6",
     "--lo", "2.4e9", "--ppm", "2", "--drift-rate", "5", "--loop"],
    # Seeded by the process id: this process's, on both sides.
    ["--if32", "--of32", "--awgn", "-10"],
    ["--drift-rate", "1", "--drift-period", "1", "-f", "1e6"],
    ["--bogus"],
]


@pytest.mark.parametrize("argv", CHANSIM_ARGV, ids=" ".join)
def test_leanchansim_cli_matches_jax(argv, monkeypatch, tmp_path):
    """leanchansim, port against JAX, on the same seeded f32 or u8 input:
    the same exit code, stdout bytes and stderr."""
    rng = np.random.default_rng(7)
    if "--iu8" in argv:
        raw = rng.integers(60, 196, 2 * 6000, dtype=np.uint8).tobytes()
    else:
        raw = (rng.standard_normal(2 * 6000) * 0.4).astype(
            np.float32).tobytes()
    want = _main(jcli.main, argv, raw, monkeypatch, tmp_path)
    got = _main(tcli.main, argv, raw, monkeypatch, tmp_path)
    assert got == want
    assert want[0] != 0 or len(want[1]) >= 6000 * 2


def test_canonical_pipe_front_matches_jax(tmp_path):
    """The canonical pipe's first three stages as `python -m` processes,
    leantsgen | leandvbtx -f 2 --cr 1/2 | leanchansim --if32 --of32
    --awgn -14 --deterministic, from each package: the same bytes."""
    def pipe(pkg):
        cmd = (f"{sys.executable} -m {pkg}.apps.leantsgen -c 30 | "
               f"{sys.executable} -m {pkg}.apps.leandvbtx -f 2 --cr 1/2 | "
               f"{sys.executable} -m {pkg}.apps.leanchansim --if32 --of32 "
               "--awgn -14 --deterministic")
        r = subprocess.run(["bash", "-o", "pipefail", "-c", cmd],
                           capture_output=True, cwd=REPO, timeout=300)
        assert r.returncode == 0, r.stderr.decode()[-2000:]
        return r.stdout
    want, got = pipe("leansdr_tpu"), pipe("leansdr_tpu_torch")
    assert len(want) > 100000 and got == want


# ------------------------------------------------------- the receiver

SIGMA = 10.0                      # --awgn, in float-scaled input units
READS = (5000, 7000, 4000)        # samples per process() call
KW = dict(Fs=2.4e6, Fm=2e6, rate="7/8", float_scale=75.0, anf=0,
          exact_lut=False, awgn=SIGMA, Finfo=500.0)


def test_preprocess_awgn_matches_jax():
    """DvbsReceiver(awgn=...)._preprocess on three reads of uneven sizes,
    the noise added before the derotator: equal to the JAX receiver's,
    with noise_draws equal after each read."""
    kw = dict(KW, Fderot=3e3)
    j = JR.DvbsReceiver(JR.RxConfig(**kw))
    t = TR.DvbsReceiver(TR.RxConfig(**kw), device="cpu")
    x = _iq(sum(READS), seed=3) * 75
    o = 0
    for n in READS:
        want = j._preprocess(x[o:o + n])
        got = t._preprocess(x[o:o + n])
        np.testing.assert_array_equal(got, want)
        assert t.noise_draws == j.noise_draws > 2 * (o + n)
        o += n
    assert t.derot.index == j.derot.index
    # Without the derotator the output is the input plus wgn_c's noise.
    t = TR.DvbsReceiver(TR.RxConfig(**KW), device="cpu")
    noise, used = T.wgn_c(READS[0], SIGMA)
    np.testing.assert_array_equal(t._preprocess(x[:READS[0]]),
                                  x[:READS[0]] + noise)
    assert t.noise_draws == used


def _stimulus():
    """Rate 7/8 at 1.2 samples per symbol (2.4 Msps, a 0.3-sample
    delay), the modulator's unit-rms scale (float_scale 75 in the
    receiver), no noise of its own."""
    from scipy.signal import resample_poly
    iq = dvbs_tx.modulate(tsgen.generate(40),
                          dvbs_tx.TxConfig(rate="7/8", interp=2))
    z = resample_poly(iq[:, 0] + 1j * iq[:, 1], 6, 1)[3::10]
    return np.stack([z.real, z.imag], -1).astype(np.float32)[:sum(READS)]


def _record(rx, planes, packed, dout, ts):
    return dict(ts=ts, planes=planes, dout=[np.array(d) for d in dout],
                packed=(np.concatenate(packed) if packed
                        else np.empty(0, np.int32)),
                noise_draws=rx.noise_draws,
                sample_backlog=np.array(rx.sample_backlog),
                byte_backlog=np.array(rx.byte_backlog),
                mpegbyte_backlog=np.array(rx.mpegbyte_backlog))


def _capture_deconv(rx, dout):
    f = rx.deconv.process

    def wrap(*a):
        out = f(*a)
        dout.append(out)
        return out
    rx.deconv.process = wrap


def _jax_side(x, ckpt):
    """The JAX receiver (Pallas demod in interpret mode) over READS; its
    record per read, and its checkpoint after read `ckpt`. Runs in the
    child process (python this_file ARGS OUT)."""
    from leansdr_tpu.dsp import receiver_pallas as jrp
    j = JR.DvbsReceiver(JR.RxConfig(use_pallas=True, **KW))
    packed, dout = [], []
    demod = jrp.demod_pallas

    def jd(*a, **k):
        out = demod(*a, **k)
        packed.append(np.asarray(out[1]).reshape(out[1].shape[0], -1)[:, 0])
        return out
    jrp.demod_pallas = jd
    _capture_deconv(j, dout)
    recs, blob, o = [], None, 0
    for k, n in enumerate(READS):
        if k == ckpt:
            wrap = j.deconv.__dict__.pop("process")     # not pickled
            blob = j.save_state()
            j.deconv.process = wrap
        ts = j.process(x[o:o + n])
        planes = np.asarray(j._planes).reshape(rk.NSTATE, -1)[:, 0]
        recs.append(_record(j, planes, packed, dout, ts))
        packed.clear()
        dout.clear()
        o += n
    return recs, blob


def _port_side(rx, x, reads, monkeypatch):
    packed, dout = [], []
    demod = rk.demod

    def td(*a):
        out = demod(*a)
        packed.append(out[1][:, 0].numpy())
        return out
    monkeypatch.setattr(rk, "demod", td)
    _capture_deconv(rx, dout)
    recs, o = [], sum(READS) - sum(reads)
    for n in reads:
        ts = rx.process(x[o:o + n])
        recs.append(_record(rx, rx._planes[:, 0].numpy().copy(), packed,
                            dout, ts))
        packed.clear()
        dout.clear()
        o += n
    return recs


def _same(want, got, tag):
    for k, (a, b) in enumerate(zip(want, got, strict=True)):
        pj, pt = a["packed"], b["packed"]
        assert pj.shape == pt.shape, (tag, k)
        v = ((pj >> 24) & 1) == 1
        assert np.array_equal((pt >> 24) & 1, (pj >> 24) & 1), (tag, k)
        assert np.array_equal(pt[v] & 0xFFFFFF, pj[v] & 0xFFFFFF), (tag, k)
        assert len(a["dout"]) == len(b["dout"]), (tag, k)
        for u, w in zip(a["dout"], b["dout"]):
            np.testing.assert_array_equal(w, u, err_msg=f"{tag} {k} bytes")
        for key in ("ts", "sample_backlog", "byte_backlog",
                    "mpegbyte_backlog"):
            np.testing.assert_array_equal(b[key], a[key],
                                          err_msg=f"{tag} {k} {key}")
        assert a["noise_draws"] == b["noise_draws"], (tag, k)
        for row in range(rk.NSTATE):
            d = float(b["planes"][row]) - float(a["planes"][row])
            if row == 1:                    # phase: one turn is 65536
                d = (d + 32768) % 65536 - 32768
            assert abs(d) <= max(1e-3, 1e-4 * abs(float(a["planes"][row]))), \
                (tag, k, row)


def test_receiver_awgn_matches_jax(monkeypatch, tmp_path):
    """DvbsReceiver with --awgn over three reads (16000 samples) from a
    cold start, and resumed after the second from a JAX checkpoint
    (convert.from_jax_dvbs_checkpoint carries noise_draws): equal to the
    JAX receiver, which runs in a child process meanwhile."""
    x = _stimulus()
    assert len(x) == sum(READS)
    src, dst = tmp_path / "args.pkl", tmp_path / "out.pkl"
    src.write_bytes(pickle.dumps(dict(x=x, ckpt=2)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {FMA_OFF}",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    proc = subprocess.Popen([sys.executable, __file__, str(src), str(dst)],
                            env=env, cwd=str(REPO), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    try:
        t = TR.DvbsReceiver(TR.RxConfig(**KW), device="cpu")
        got = _port_side(t, x, READS, monkeypatch)
    finally:
        log = proc.communicate(timeout=900)[0].decode(errors="replace")
    assert proc.returncode == 0, log[-3000:]
    want, blob = pickle.loads(dst.read_bytes())
    _same(want, got, "cold")
    assert sum(len(d) for r in got for d in r["dout"]) > 1000
    assert t.noise_draws > 2 * (sum(READS) - len(t.sample_backlog))
    r = TR.DvbsReceiver(TR.RxConfig(**KW), device="cpu")
    r.load_state(from_jax_dvbs_checkpoint(blob))
    assert r.noise_draws == want[1]["noise_draws"]
    _same(want[2:], _port_side(r, x, READS[2:], monkeypatch), "resumed")
    # The port's own checkpoint carries the draw count too.
    u = TR.DvbsReceiver(TR.RxConfig(**KW), device="cpu")
    u.load_state(t.save_state())
    assert u.noise_draws == t.noise_draws


if __name__ == "__main__":
    # The JAX side of test_receiver_awgn_matches_jax.
    args = pickle.loads(Path(sys.argv[1]).read_bytes())
    Path(sys.argv[2]).write_bytes(pickle.dumps(_jax_side(**args)))
