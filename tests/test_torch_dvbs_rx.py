"""The port's single-carrier receiver (leansdr_tpu_torch.pipelines.dvbs_rx.
DvbsReceiver, on the plain versions of its kernels) against the JAX
DvbsReceiver on its kernel path (exact_lut=False, use_pallas=True: the
Pallas demod in interpret mode; --resample on JAX's FirFilterDevice, as
the JAX receiver builds it on an accelerator), at three samples-per-
symbol ratios, each with a fractional sample delay:

  omega 1.2   rate 7/8, hard decisions, --anf 1 (the CLI default), linear
  omega 2     rate 1/2, --viterbi --sampler rrc --fastlock (matched filter)
  omega 4.29  --resample (10 Msps, decim 7, 79 taps), rate 3/4, --viterbi,
              a carrier offset the loop tracks, so the resampler retunes

The JAX receiver runs in a child process with multiply-add contraction
off (XLA_FLAGS=--xla_cpu_max_isa=AVX: no FMA instructions), so both sides
round each float operation alike, as the port's plain versions and its
CUDA kernels (built with --fmad=false) do. With FMA on, XLA rounds the
demod's interpolated sample and phase error differently in the last bit,
and over 16k samples a few soft costs land one s8 grid step apart
(ROADMAP queue 3); with it off they are equal.

Tolerance: the demod's valid flag exactly equal on every sample, symbol
and soft cost exactly equal on every valid sample (non-emitted samples'
words carry a discarded decision); the decoders' inputs, the decoded
bytes, the byte and MPEG backlogs and the TS exactly equal. Measurements
(FREQ cycles/sample, SS, MER) and every row of the demod's float state
within max(1e-3, 1e-4*|v|) (phase modulo one turn); the resampler's
output backlog within the FIR module's 2e-4*max|x|.
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

from leansdr_tpu.pipelines import dvbs_tx, tsgen

from leansdr_tpu_torch.dsp import receiver_kernel as rk
from leansdr_tpu_torch.pipelines import dvbs_rx as T

# Single-threaded torch: the plain versions run many small ops, which
# OpenMP threads only slow down, most of all beside other test workers.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FMA_OFF = "--xla_cpu_max_isa=AVX"
N = 8192                   # demod samples per call
BACKLOGS = ("byte_backlog", "mpegbyte_backlog")


def _stimulus(rate, up, down, delay, npkt, f=0.0):
    """The modulator's 2-sps output resampled by up/down with a delay of
    delay/up samples at the output rate, then shifted by f cycles per
    output sample."""
    iq = dvbs_tx.modulate(tsgen.generate(npkt),
                          dvbs_tx.TxConfig(rate=rate, interp=2))
    z = resample_poly(iq[:, 0] + 1j * iq[:, 1], up, 1)[delay::down]
    z = z * np.exp(2j * np.pi * f * np.arange(len(z)))
    return np.stack([z.real, z.imag], -1).astype(np.float32)


def _record(rx, planes, demods, dins, douts, ts):
    """What the comparison reads after one process() call."""
    return dict(ts=ts,
                packed=(np.concatenate(demods) if demods
                        else np.empty(0, np.int32)),
                din=list(dins), dout=list(douts), planes=planes,
                meas={k: np.array(rx.meas[k]) for k in ("freq", "ss",
                                                         "mer")},
                sample_backlog=np.array(rx.sample_backlog),
                **{k: np.array(getattr(rx, k)) for k in BACKLOGS})


def _capture_deconv(rx, dins, douts):
    f = rx.deconv.process

    def wrap(*a):
        dins.append(tuple(np.array(v) for v in a))
        out = f(*a)
        douts.append(np.array(out))
        return out
    rx.deconv.process = wrap


def _jax_run(kw, x, n_in, calls, freqw=None):
    """The JAX receiver over `calls` slices of x; per call, its record.
    Runs in the child process (see _start_jax)."""
    import jax.numpy as jnp
    from leansdr_tpu.dsp import fir_pallas
    from leansdr_tpu.dsp import receiver_pallas as jrp
    from leansdr_tpu.pipelines import dvbs_rx as J
    j = J.DvbsReceiver(J.RxConfig(use_pallas=True, **kw))
    if j.resampler is not None:
        r = j.resampler
        j.resampler = fir_pallas.FirFilterDevice(r.coeffs, r.decim,
                                                 r.freq_tol, interpret=True)
    if freqw is not None:
        planes = np.asarray(j._planes).copy()
        planes.reshape(rk.NSTATE, -1)[2, 0] = freqw
        j._planes = jnp.asarray(planes)
    demods, dins, douts = [], [], []
    demod = jrp.demod_pallas

    def jd(*a, **k):
        out = demod(*a, **k)
        demods.append(np.asarray(out[1]).reshape(out[1].shape[0], -1)[:, 0])
        return out
    jrp.demod_pallas = jd
    _capture_deconv(j, dins, douts)
    recs = []
    for k in range(calls):
        ts = j.process(x[k * n_in:(k + 1) * n_in])
        planes = np.asarray(j._planes).reshape(rk.NSTATE, -1)[:, 0]
        recs.append(_record(j, planes, demods, dins, douts, ts))
        for v in (demods, dins, douts):
            v.clear()
    if j.resampler is not None:
        recs[-1]["resampler"] = (j.resampler.current_freq,
                                 np.asarray(j.resampler.taps_r))
    return recs


def _start_jax(tmp_path, **args):
    """_jax_run(**args) in a child process with FMA contraction off in
    XLA; returns (process, path of its result)."""
    src, dst = tmp_path / "jax_args.pkl", tmp_path / "jax_recs.pkl"
    src.write_bytes(pickle.dumps(args))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {FMA_OFF}",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    proc = subprocess.Popen([sys.executable, __file__, str(src), str(dst)],
                            env=env, cwd=str(REPO), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    return proc, dst


def _port_run(kw, x, n_in, calls, monkeypatch, freqw=None):
    t = T.DvbsReceiver(T.RxConfig(**kw), device="cpu")
    if freqw is not None:
        t._planes[2, 0] = freqw
    demods, dins, douts = [], [], []
    demod = rk.demod

    def td(*a):
        out = demod(*a)
        demods.append(out[1][:, 0].numpy())
        return out
    monkeypatch.setattr(rk, "demod", td)
    _capture_deconv(t, dins, douts)
    recs = []
    for k in range(calls):
        ts = t.process(x[k * n_in:(k + 1) * n_in])
        recs.append(_record(t, t._planes[:, 0].numpy().copy(), demods, dins,
                            douts, ts))
        for v in (demods, dins, douts):
            v.clear()
    return t, recs


def _check(k, rj, rt):
    pj, pt = rj["packed"], rt["packed"]
    assert pj.shape == pt.shape, k
    vj, vt = (pj >> 24) & 1, (pt >> 24) & 1
    v = vj == 1
    bad = np.nonzero((vj != vt) | ((((pj ^ pt) & 0xFFFFFF) != 0) & v))[0]
    assert not len(bad), (f"call {k}: {len(bad)} packed samples differ, "
                          f"first {bad[0]}: jax {pj[bad[0]]:#x} port "
                          f"{pt[bad[0]]:#x}")
    assert len(rj["din"]) == len(rt["din"]), k
    for i, (a, b) in enumerate(zip(rj["din"], rt["din"])):
        assert len(a) == len(b), (k, i)
        for u, w in zip(a, b):
            np.testing.assert_array_equal(u, w, err_msg=f"decoder in {k}")
    for a, b in zip(rj["dout"], rt["dout"]):
        np.testing.assert_array_equal(a, b, err_msg=f"decoded bytes {k}")
    np.testing.assert_array_equal(rj["ts"], rt["ts"], err_msg=f"TS {k}")
    for name in BACKLOGS:
        np.testing.assert_array_equal(rj[name], rt[name], err_msg=name)
    sj, st = rj["planes"], rt["planes"]
    for row in range(rk.NSTATE):
        d = float(st[row]) - float(sj[row])
        if row == 1:                        # phase: one turn is 65536
            d = (d + 32768) % 65536 - 32768
        assert abs(d) <= max(1e-3, 1e-4 * abs(float(sj[row]))), \
            (k, row, sj[row], st[row])
    for key in ("freq", "ss", "mer"):
        a, b = rj["meas"][key], rt["meas"][key]
        assert a.shape == b.shape, key
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-3, err_msg=key)
    # Raw input, or the resampler's output (the FIR module's bar).
    a = rj["sample_backlog"]
    np.testing.assert_allclose(
        rt["sample_backlog"], a, rtol=0,
        atol=2e-4 * max(1.0, np.abs(a).max(initial=0)))


def _drive(x, kw, n_in, calls, monkeypatch, tmp_path, freqw=None):
    """Both receivers over the same slices (JAX in its child process
    meanwhile); every call's records compared. Returns the port's
    receiver and both sides' records."""
    proc, dst = _start_jax(tmp_path, kw=kw, x=x, n_in=n_in, calls=calls,
                           freqw=freqw)
    try:
        t, rt = _port_run(kw, x, n_in, calls, monkeypatch, freqw)
    finally:
        log = proc.communicate(timeout=900)[0].decode(errors="replace")
    assert proc.returncode == 0, log[-3000:]
    rj = pickle.loads(dst.read_bytes())
    assert len(rj) == len(rt) == calls
    for k in range(calls):
        _check(k, rj[k], rt[k])
    return t, rj, rt


def _nonempty(rt):
    assert sum(int(((r["packed"] >> 24) & 1).sum()) for r in rt) > 1000
    assert sum(len(o) for r in rt for o in r["dout"]) > 200


def test_receiver_omega_1_2_hard_matches_jax(monkeypatch, tmp_path):
    x = _stimulus("7/8", 6, 10, 3, 40)                # 1.2 sps, delay 0.3
    kw = dict(Fs=2.4e6, Fm=2e6, rate="7/8", float_scale=75.0,
              exact_lut=False, anf=1, Finfo=500.0)
    t, _, rt = _drive(x, kw, N, 2, monkeypatch, tmp_path)
    _nonempty(rt)
    assert t.notch is not None and len(t.meas["freq"]) >= 2


def test_receiver_omega_2_viterbi_rrc_matches_jax(monkeypatch, tmp_path):
    x = _stimulus("1/2", 6, 3, 1, 20, 2e-4)           # 2 sps, delay 1/3
    kw = dict(Fs=4e6, Fm=2e6, rate="1/2", float_scale=75.0,
              exact_lut=False, viterbi=True, sampler="rrc", fastlock=True,
              anf=0, Finfo=500.0)
    t, _, rt = _drive(x, kw, N, 2, monkeypatch, tmp_path)
    _nonempty(rt)
    assert t.mf_taps is not None and t.deconv.nsyncs == 4


def test_receiver_resample_omega_4_29_matches_jax(monkeypatch, tmp_path):
    """10 Msps, 333.3 ksym/s: decim 7, Fs_eff 1.43 Msps, 79 taps; a 10 kHz
    carrier offset, given to the loop with --tune, so the first
    measurement re-modulates the resampler's taps (on the same chunk on
    both sides, since the measurements match)."""
    x = _stimulus("3/4", 15, 1, 0, 20, 1e-3)[5:]       # 30 sps, 10 kHz
    kw = dict(Fs=10e6, Fm=1e7 / 30, rate="3/4", float_scale=75.0,
              exact_lut=False, viterbi=True, resample=True, anf=0,
              Finfo=500.0, Ftune=10e3)
    t, rj, rt = _drive(x, kw, 7 * N, 2, monkeypatch, tmp_path)
    _nonempty(rt)
    assert t.decim == 7 and len(t.resampler.coeffs) == 79
    assert abs(t.params.omega - 30 / 7) < 1e-12
    freq, taps_r = rj[-1]["resampler"]
    assert t.resampler.current_freq == freq != 0.0
    np.testing.assert_array_equal(t.resampler.taps_r.numpy(), taps_r)


@pytest.mark.parametrize("drift", [False, True])
def test_receiver_allow_drift_matches_jax(drift, monkeypatch, tmp_path):
    """The single-carrier receiver honours --drift, as the JAX one does
    (the fleet clamps whatever the flag says): with freqw placed beyond
    max_freqw, the chunk-end clamp pulls it back to the middle of the
    window without --drift and leaves it with --drift, on both sides."""
    x = _stimulus("1/2", 6, 3, 1, 14)
    kw = dict(Fs=4e6, Fm=2e6, rate="1/2", float_scale=75.0,
              exact_lut=False, anf=0, allow_drift=drift)
    hi = T.DvbsReceiver(T.RxConfig(**kw), device="cpu").params.freq_limits[1]
    t, _, _ = _drive(x[:1024], kw, 1024, 1, monkeypatch, tmp_path,
                     freqw=hi + 300.0)
    fw = float(t._planes[2, 0])
    assert (fw > hi) == drift, (fw, hi)


if __name__ == "__main__":
    # The JAX side of _drive: python test_torch_dvbs_rx.py ARGS.pkl OUT.pkl
    args = pickle.loads(Path(sys.argv[1]).read_bytes())
    Path(sys.argv[2]).write_bytes(pickle.dumps(_jax_run(**args)))
