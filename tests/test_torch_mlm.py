"""The port's FM multi-channel receiver (leansdr_tpu_torch.pipelines.mlm_rx,
dsp/fft.py, dsp/blocks.py `_first_order_scan`, apps/leanmlmrx.py)
against the JAX package's, on the CPU.

Cases:
  fft_planes  N=64 (the direct DFT matmul) and N=1024 (four-step) on
      random planes.
  _first_order_scan  the odd/even associative scan at lengths 1 to 1001,
      1-D with a scalar y0 and 2-D with a per-column y0.
  channelize  the u16 phases of 4 channels (N=64, one in each of the
      bin-fraction classes' weights) on 0.08 s of a 25.6 Msps capture.
  MlmReceiver  3 FM carriers with tones of 1, 2 and 3 kHz, a dead channel
      and noise, 2^21 samples: against JAX in 2 reads, plain and with
      --squelch 0.8 and --wav; in 4 reads each tone recovered within 50
      Hz (tests/test_mlm.py) and the dead channel squelched.
  the CLI  `python -m leansdr_tpu_torch.apps.leanmlmrx --device cpu` on
      2^20 samples of s16, 3 channels (one muted with "(...)"), against
      the JAX CLI's bytes; parse_channel, the WAV header and the
      MUTE/UNMUTE control channel.

The JAX side runs in one child process with multiply-add contraction off
(XLA_FLAGS=--xla_cpu_max_isa=AVX), as tests/test_torch_dvbs_rx.py
explains.

Tolerance: the DFT's matmuls sum in another order (MKL against XLA's
Eigen), so fft_planes is held within 2e-6 x max|y| (float32 sums of 64
and 1024 products; seen ~4e-7). _first_order_scan is equal: JAX's
recursion, the same float32 operations in the same order. channelize:
the phases are equal but where the two DFTs put a combined bin on the
two sides of a truncation edge (an integer, or the overflow halving's
126): the test counts those entries (under 1 in 10^4) and checks each.
The audio (int8, or WAV's u8) is equal but within 1 LSB at fewer than 1
sample in 10^3, the phase steps an edge moves (seen: none).
"""

import io
import os
import pickle
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from leansdr_tpu_torch.apps import leanmlmrx as tcli
from leansdr_tpu_torch.dsp.blocks import _first_order_scan
from leansdr_tpu_torch.dsp.fft import fft_planes
from leansdr_tpu_torch.pipelines import mlm_rx as T

# Single-threaded torch, as in every port test file.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FMA_OFF = "--xla_cpu_max_isa=AVX"
FS, FC = 25.6e6, 98e6
# The carriers' frequencies, tones (Hz) and amplitudes; DEAD is an
# enabled channel with no carrier. The channelize case's frequencies
# fall at bin fractions 0.0, 0.25, 0.5 and 0.75 (N=64: 400 kHz bins).
CARRIERS = ((98.4e6, 1000.0), (97.5e6, 2000.0), (99.1e6, 3000.0))
DEAD = 101.0e6
CH_FREQS = (98.4e6, 98.5e6, 97.0e6, 99.5e6)
N_RX = 1 << 21           # the receivers' capture: 4 reads for the tones,
READS = 4                # 2 against JAX (each read shape a JAX compile)
SCAN_LENGTHS = (1, 2, 7, 1001)
CLI_ARGS = ["--fs", "25.6e6", "--fc", "100e6", "-N", "64", "--fa", "44100",
            "100.8", "99.2", "(101.6)"]


def _fm(n, carriers, fc, seed=0, amp=1000.0, noise=30.0, dev=75e3):
    """[n] complex128: FM carriers (peak deviation `dev`) with sine
    tones."""
    t = np.arange(n)
    x = np.zeros(n, complex)
    for f, tone in carriers:
        x += amp * np.exp(1j * (2 * np.pi * (f - fc) * t / FS
                                + (dev / tone) * np.sin(
                                    2 * np.pi * tone * t / FS)))
    rng = np.random.default_rng(seed)
    return x + noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))


def _rx_capture():
    """The receiver case's capture: 25 kHz deviation, so that a carrier's
    mean square discriminator output (~0.04 of full scale) stays under
    --squelch 0.8's 0.2, while a dead channel's uniform phase steps
    (~1/3) go over it."""
    return _fm(N_RX, CARRIERS, FC, dev=25e3).astype(np.complex64)


def _cli_capture():
    """2^20 samples of s16 (one read of the CLI's): carriers at +-800 kHz
    (1 and 2.5 kHz tones) and the muted one at +1.6 MHz (3.7 kHz), as
    tests/test_mlm.py's golden."""
    z = _fm(1 << 20, ((100.8e6, 1000.0), (99.2e6, 2500.0),
                        (101.6e6, 3700.0)), 100e6, amp=8000.0, noise=0.0)
    iq = np.empty((len(z), 2), np.int16)
    iq[:, 0] = np.round(z.real)
    iq[:, 1] = np.round(z.imag)
    return iq.tobytes()


def _planes(n, N, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, N)).astype(np.float32) * 100
            for _ in range(2)]


def _scan_inputs():
    rng = np.random.default_rng(5)
    return [(rng.standard_normal(n).astype(np.float32),
             rng.standard_normal((n, 3)).astype(np.float32),
             rng.standard_normal(3).astype(np.float32))
            for n in SCAN_LENGTHS]


def _ch_cfg(mod):
    return mod.MlmConfig(Fs=FS, Fc=FC,
                         channels=[mod.Channel(F=f) for f in CH_FREQS])


def _ch_windows():
    """The channelize case's [F, N] planes (the receiver's windows)."""
    cfg = _ch_cfg(T)
    stride = T.channel_weights(cfg, T.resolve_rates(cfg)[0])[3]
    x = _fm(2_048_000, [(f, 1500.0) for f in CH_FREQS], FC).astype(
        np.complex64)
    nf = (len(x) - 64) // stride + 1
    idx = np.arange(nf)[:, None] * stride + np.arange(64)[None, :]
    return x[idx].real.astype(np.float32), x[idx].imag.astype(np.float32)


def _rx_cfgs(mod):
    chans = [mod.Channel(F=f) for f, _ in CARRIERS] + [mod.Channel(F=DEAD)]
    return {"plain": mod.MlmConfig(Fs=FS, Fc=FC, channels=chans),
            "squelch wav": mod.MlmConfig(Fs=FS, Fc=FC, channels=chans,
                                         squelch=0.8, wav=True)}


def _drive(rx, reads=READS):
    x = _rx_capture()
    step = -(-len(x) // reads)
    return np.concatenate([rx.process(x[i:i + step])
                           for i in range(0, len(x), step)])


def jax_runs():
    """Every case through the JAX package (the CLI through its main())."""
    import jax.numpy as jnp
    from leansdr_tpu.apps import leanmlmrx as jcli
    from leansdr_tpu.dsp import fft as jfft
    from leansdr_tpu.dsp.blocks import _first_order_scan as jscan
    from leansdr_tpu.dsp.math_utils import atan2_poly
    from leansdr_tpu.pipelines import mlm_rx as J
    out = {"fft": {N: [np.asarray(v) for v in jfft.fft_planes(
        *map(jnp.asarray, _planes(37, N, N)), N)] for N in (64, 1024)}}
    out["scan"] = [
        (np.asarray(jscan(jnp.asarray(a), jnp.float32(y0[0]), 0.0113)),
         np.asarray(jscan(jnp.asarray(b), jnp.asarray(y0), 0.37)))
        for a, b, y0 in _scan_inputs()]
    cfg = _ch_cfg(J)
    ib, w, _, _ = J.channel_weights(cfg, J.resolve_rates(cfg)[0])
    xr, xi = _ch_windows()
    args = (jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(ib),
            jnp.asarray(w))
    out["ph"] = np.asarray(J.channelize(*args))

    # The combined bins before the truncation, by channelize's steps.
    br, bi = jfft.fft_planes(args[0], args[1], 64)
    b = [br[:, ib], bi[:, ib], br[:, (ib + 1) % 64], bi[:, (ib + 1) % 64]]
    d = [w[None, :, 0, k, 0] * b[0] + w[None, :, 0, k, 1] * b[1]
         + w[None, :, 1, k, 0] * b[2] + w[None, :, 1, k, 1] * b[3]
         for k in (0, 1)]
    for _ in range(10):
        over = (d[0] < -126) | (d[0] > 126) | (d[1] < -126) | (d[1] > 126)
        d = [jnp.where(over, v * 0.5, v) for v in d]
    out["pre"] = [np.asarray(v) for v in d]
    ph = jnp.trunc(atan2_poly(jnp.trunc(d[1]), jnp.trunc(d[0]))
                   * jnp.float32(65536 / (2 * np.pi))).astype(jnp.int32)
    out["pre_ph"] = np.asarray(ph & 0xFFFF)

    out["rx"] = {k: _drive(J.MlmReceiver(c), 2)
                 for k, c in _rx_cfgs(J).items()}

    class Std:
        def __init__(self, raw=b""):
            self.buffer = io.BytesIO(raw)
    sys.stdin, stdout = Std(_cli_capture()), sys.stdout
    sys.stdout = Std()
    try:
        assert jcli.main(list(CLI_ARGS)) == 0
        out["cli"] = sys.stdout.buffer.getvalue()
    finally:
        sys.stdout = stdout
    return out


@pytest.fixture(scope="module")
def jax(tmp_path_factory):
    """The JAX results, computed in a child process started at the first
    request; call it to wait for them."""
    dst = tmp_path_factory.mktemp("jax_mlm") / "out.pkl"
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


def _tone(au, fau):
    w = au[500:500 + 2048].astype(np.float64) * np.hanning(2048)
    sp = np.abs(np.fft.rfft(w))
    f = np.fft.rfftfreq(2048, 1 / fau)
    return f[np.argmax(sp[5:]) + 5]


@pytest.mark.parametrize("name", ["plain", "squelch wav"])
def test_receiver_matches_jax(name, jax):
    cfg = _rx_cfgs(T)[name]
    rx = T.MlmReceiver(cfg, device="cpu")
    au = _drive(rx, 2)
    assert au.dtype == np.int8 and len(au) > 3000
    if cfg.squelch:
        # The dead channel (noise) is muted, the carriers pass.
        assert rx.rms[3] > 0.2 >= rx.rms[:3].max()
    else:
        # Each carrier alone carries its tone; the dead channel alone,
        # squelched, is silent.
        for f, tone in CARRIERS:
            one = T.MlmReceiver(T.MlmConfig(Fs=FS, Fc=FC,
                                            channels=[T.Channel(F=f)]),
                                device="cpu")
            assert abs(_tone(_drive(one), one.Fau) - tone) < 50
        dead = T.MlmReceiver(T.MlmConfig(Fs=FS, Fc=FC, squelch=0.8,
                                         channels=[T.Channel(F=DEAD)]),
                             device="cpu")
        assert np.abs(_drive(dead).astype(np.float64)).mean() < 1
    want = jax()["rx"][name]
    assert au.shape == want.shape
    diff = np.abs(au.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).sum() <= len(au) // 1000


def test_cli_matches_jax(jax, tmp_path):
    src = tmp_path / "capture.s16"
    src.write_bytes(_cli_capture())
    env = dict(os.environ, PYTHONPATH=str(REPO))
    with open(src, "rb") as f:
        r = subprocess.run([sys.executable, "-m",
                            "leansdr_tpu_torch.apps.leanmlmrx", "--device",
                            "cpu"] + CLI_ARGS, stdin=f, capture_output=True,
                           env=env, cwd=str(REPO), timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert b"Channel quadrature rate 176.400 kHz" in r.stderr
    a = np.frombuffer(r.stdout, np.int8).astype(int)
    b = np.frombuffer(jax()["cli"], np.int8).astype(int)
    assert a.shape == b.shape and len(a) > 1500
    diff = np.abs(a - b)
    assert diff.max() <= 1 and (diff > 0).sum() <= len(a) // 1000


@pytest.mark.parametrize("N", [64, 1024])
def test_fft_planes_matches_jax(N, jax):
    xr, xi = _planes(37, N, N)
    got = fft_planes(torch.from_numpy(xr), torch.from_numpy(xi), N)
    ref = np.fft.fft(xr.astype(np.float64) + 1j * xi.astype(np.float64))
    for g, w, r in zip(got, jax()["fft"][N], (ref.real, ref.imag)):
        bar = 2e-6 * np.abs(r).max()
        assert np.abs(g.numpy() - w).max() < bar
        assert np.abs(g.numpy() - r).max() < bar


def test_first_order_scan_matches_jax(jax):
    for (a, b, y0), (wa, wb) in zip(_scan_inputs(), jax()["scan"]):
        ga = _first_order_scan(torch.from_numpy(a), float(y0[0]), 0.0113)
        gb = _first_order_scan(torch.from_numpy(b), torch.from_numpy(y0),
                               0.37)
        np.testing.assert_array_equal(ga.numpy(), wa)
        np.testing.assert_array_equal(gb.numpy(), wb)
    # The recurrence it evaluates, to float32 rounding.
    a = _scan_inputs()[-1][0]
    y, want = 0.25, []
    for v in a.astype(np.float64):
        y = (1 - 0.0113) * y + 0.0113 * v
        want.append(y)
    got = _first_order_scan(torch.from_numpy(a), 0.25, 0.0113).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_channelize_matches_jax(jax):
    """Phases equal but at truncation edges, each of which is checked:
    there the two sides' combined bins (before the trunc) round the same
    value to neighbouring cells."""
    cfg = _ch_cfg(T)
    ib, w, _, _ = T.channel_weights(cfg, T.resolve_rates(cfg)[0])
    xr, xi = (torch.from_numpy(v) for v in _ch_windows())
    args = (xr, xi, torch.from_numpy(ib), torch.from_numpy(w))
    ph = T.channelize(*args).numpy()
    want = jax()["ph"]
    np.testing.assert_array_equal(jax()["pre_ph"], want)
    assert ph.shape == want.shape and ph.dtype == want.dtype == np.int32
    d_p = [v.numpy() for v in T.channelize_pre(*args)]
    d_j = jax()["pre"]
    bad = np.argwhere(ph != want)
    assert len(bad) < ph.size // 10000, (len(bad), ph.size)
    for f, c in bad:
        p = np.array([d_p[0][f, c], d_p[1][f, c]])
        j = np.array([d_j[0][f, c], d_j[1][f, c]])
        # The same value (or, across the halving's edge, twice it) on
        # the two sides of a truncation edge.
        r = max(abs(p).max(), abs(j).max()) / min(abs(p).max(),
                                                   abs(j).max())
        same = np.abs(p - j).max() < 1e-3 * max(1.0, np.abs(j).max())
        assert same or abs(r - 2) < 1e-3, (f, c, p, j)
        assert (np.trunc(p) != np.trunc(j)).any(), (f, c, p, j)
    # All four channels turn: the phases cover the circle.
    assert all(len(np.unique(ph[:, c] >> 12)) == 16 for c in range(4))


def test_cli_helpers():
    """parse_channel, write_wav_header and the MUTE/UNMUTE channel as the
    JAX CLI's (pure Python)."""
    from leansdr_tpu.apps import leanmlmrx as jcli
    from leansdr_tpu.pipelines import mlm_rx as J
    for spec in ("99.5", "(101.2)", "98:0.2:98.6", "(97:0.5:98)"):
        got, want = [], []
        tcli.parse_channel(got, spec, T.Channel)
        jcli.parse_channel(want, spec, J.Channel)
        assert [(c.F, c.enabled) for c in got] == \
            [(c.F, c.enabled) for c in want]
    bt, bj = io.BytesIO(), io.BytesIO()
    tcli.write_wav_header(bt, 44100)
    jcli.write_wav_header(bj, 44100)
    assert bt.getvalue() == bj.getvalue()
    assert struct.unpack("<I", bt.getvalue()[24:28]) == (44100,)
    rfd, wfd = os.pipe()
    try:
        ctl = tcli._ControlChannel(rfd)
        enabled = np.ones(4, bool)
        os.write(wfd, b"MUTE 1\nGET /MUTE=2 HTTP/1.1\nMUTE 9\nUNMUTE 1\n"
                      b"MUTE 3\npartial")
        ctl.poll(enabled)
        assert enabled.tolist() == [True, True, False, False]
        os.write(wfd, b" line\nUNMUTE 3\n")
        ctl.poll(enabled)
        assert enabled.tolist() == [True, True, False, True]
    finally:
        os.close(rfd)
        os.close(wfd)


if __name__ == "__main__":
    # The JAX side: python test_torch_mlm.py OUT.pkl
    Path(sys.argv[1]).write_bytes(pickle.dumps(jax_runs()))
