"""The port's receivers on the scan demod's routes against the JAX
receivers, TS bytes included, from a cold start and resumed from a JAX
checkpoint taken before the last call (convert.from_jax_dvbs_checkpoint,
convert.from_jax_checkpoint):

  single carrier (DvbsReceiver), rate 7/8, fastlock, --anf 0:
    exact        --exact-lut, 2.4 Msps (1.2 samples per symbol), linear
    exact rrc    --exact-lut --sampler rrc, 2.4 Msps: the polyphase
                 fir_sampler (497 taps in steps of 53) in the loop;
                 --float-scale 3975 = 75 x 53, since the filter's
                 polyphase DC gain is 1/53 and the AGC, updated once per
                 chunk at kest 0.01, would take ~800 chunks to make it up
                 (ROADMAP queue 3)
    hard-metric  --hard-metric --viterbi, 2.4 Msps: the LUT's cost
                 hardened to -1/0 under the soft decoder
    nearest      --sampler nearest (computed decisions), 4.8 Msps (2.4
                 samples per symbol: at 1.2 neither receiver decodes)
  fleet (MultiDvbsReceiver), 2 carriers at 2.4 Msps, rate 7/8, hard
  decisions, exact_lut=True, sampler "rrc", float_scale 3975, chunks of
  4096: segments=1 and segments=8 (seg_warmup 256, seg_holdoff 2; its
  checkpoint holds the dict seg_state).

Every stimulus has a fractional sample delay (ROADMAP queue 3, settled:
the emit threshold). The JAX side runs in one child process with
multiply-add contraction off (XLA_FLAGS=--xla_cpu_max_isa=AVX), as
tests/test_torch_dvbs_rx.py explains; JAX's receivers take the same
routes on the CPU (use_pallas=False: the XLA scan).

Tolerance: the decoder's inputs (symbols; with --viterbi, costs), the
decoded bytes, the byte and MPEG backlogs and the TS packets are equal
on every call, and so are the fleet's packed fetch buffers. The demod's
integer state is equal; its float state and the FREQ/SS/MER measurements
within 1e-4 relative plus STATE_ATOL (see there: the AGC's rsqrt on
XLA's side, tests/test_torch_scan_demod.py, can move a sample across an
s8 cell edge over a long stream).
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

from leansdr_tpu_torch.convert import (from_jax_checkpoint,
                                       from_jax_dvbs_checkpoint)
from leansdr_tpu_torch.pipelines import dvbs_rx as T
from leansdr_tpu_torch.pipelines.multi_rx import MultiDvbsReceiver

# Single-threaded torch, as in every port test file.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FMA_OFF = "--xla_cpu_max_isa=AVX"
RRC_SCALE = 75.0 * 53
BASE = dict(Fm=2e6, rate="7/8", fastlock=True, anf=0, Finfo=500.0,
            float_scale=75.0)
# name: (RxConfig fields, stimulus (up, down, delay), samples per call)
SC = {
    "exact": (dict(Fs=2.4e6, exact_lut=True), (6, 10, 3), (8192,) * 4),
    "exact rrc": (dict(Fs=2.4e6, exact_lut=True, sampler="rrc",
                       float_scale=RRC_SCALE), (6, 10, 3), (8192,) * 4),
    "hard-metric": (dict(Fs=2.4e6, hard_metric=True, viterbi=True),
                    (6, 10, 3), (8192,) * 3),
    "nearest": (dict(Fs=4.8e6, exact_lut=False, sampler="nearest"),
                (12, 10, 3), (8192,) * 6),
}
# Absolute part of the float bar per measurement and state field (the
# relative part is 1e-4). An AGC gain an ulp apart (XLA's rsqrt) can move
# an AGC'd sample across an s8 cell edge: the decision stays, but the
# LUT's phase error (and so phase and freqw, and after them the samples
# and the rrc sampler's turned taps) can move by a cell's worth, which
# the loops then track back (seen: freqw 0.174 and phase 9.8 u16 units,
# hist_p 0.05 on the exact rrc stream).
STATE_ATOL = dict(freq=1e-5, ss=1e-3, mer=1e-2, mu=1e-3, phase=32.0,
                  freqw=0.5, hist_p=0.2, hist_c=0.0, est_insp=1e-1,
                  agc_gain=1e-4, est_sp=1e-1, est_ep=1e-2, rrc_shifted=1e-5)
FLEET_CHUNK = 4096
FLEET = {
    "S=1": dict(chunks=8, seg={}),
    "S=8": dict(chunks=8, seg=dict(segments=8, seg_warmup=256,
                                   seg_holdoff=2)),
}
FLEET_CFG = dict(Fs=2.4e6, Fm=2e6, rate="7/8", fastlock=True,
                 float_scale=RRC_SCALE, exact_lut=True, viterbi=False,
                 sampler="rrc")


def _stimulus(up, down, delay, n, f=1e-4, start=0):
    """The modulator's 2-sps output at rate 7/8, up x, every down-th
    sample from `delay`, shifted by f cycles per sample: [n, 2] float32
    at unit amplitude."""
    iq = dvbs_tx.modulate(tsgen.generate(n // 900 + 8, start=start),
                          dvbs_tx.TxConfig(rate="7/8", interp=2))
    z = resample_poly(iq[:, 0] + 1j * iq[:, 1], up, 1)[delay::down][:n]
    assert len(z) == n
    z = z * np.exp(2j * np.pi * f * np.arange(n))
    return np.stack([z.real, z.imag], -1).astype(np.float32)


def _fleet_frames():
    n = FLEET_CHUNK * 8
    return np.stack([_stimulus(6, 10, 3 * (c + 1), n, (2e-5, -3e-5)[c],
                               start=500 * c) for c in range(2)])


def _record(rx, ts, dins, douts, dem):
    return dict(ts=ts, din=list(dins), dout=list(douts), dem=dem,
                meas={k: np.array(rx.meas[k]) for k in ("freq", "ss",
                                                         "mer")},
                **{k: np.array(getattr(rx, k)) for k in (
                    "sample_backlog", "byte_backlog", "mpegbyte_backlog")})


def _capture(rx):
    dins, douts = [], []
    f = rx.deconv.process

    def wrap(*a):
        dins.append(tuple(np.array(v) for v in a))
        out = f(*a)
        douts.append(np.array(out))
        return out
    rx.deconv.process = wrap
    return dins, douts


def _drive(rx, x, calls, dem_state, save_before=None):
    """rx over the calls' slices of x; per call its record, and (with
    save_before=k) the checkpoint taken before call k."""
    dins, douts = _capture(rx)
    recs, blob, o = [], None, 0
    for k, n in enumerate(calls):
        if k == save_before:
            wrap = rx.deconv.__dict__.pop("process")    # not pickled
            blob = rx.save_state()
            rx.deconv.process = wrap
        ts = rx.process(x[o:o + n])
        recs.append(_record(rx, ts, dins, douts, dem_state(rx)))
        dins.clear()
        douts.clear()
        o += n
    return recs, blob


def _fleet_drive(rx, frames, save_before=None):
    recs, blob = [], None
    for k in range(frames.shape[1] // FLEET_CHUNK):
        if k == save_before:
            blob = rx.save_state()
        pend = rx.dispatch(frames[:, k * FLEET_CHUNK:(k + 1) * FLEET_CHUNK])
        recs.append(None if pend is None else (np.asarray(pend[0]),
                                               pend[1], rx.collect(pend)))
    return recs, blob


def jax_runs():
    """Every single-carrier path and fleet run through the JAX receivers
    (the XLA scan on the CPU), with the checkpoint before the last call
    (single carrier) or the last two chunks (fleet)."""
    from leansdr_tpu.pipelines import dvbs_rx as J
    from leansdr_tpu.pipelines.multi_rx import MultiDvbsReceiver as JaxRx
    out = {}
    for name, (fields, stim, calls) in SC.items():
        rx = J.DvbsReceiver(J.RxConfig(**(BASE | fields)))
        assert not rx.use_pallas
        x = _stimulus(*stim, sum(calls))
        out[name] = _drive(rx, x, calls, lambda r: {
            k: np.asarray(v) for k, v in r.state.items()},
            save_before=len(calls) - 1)
    frames = _fleet_frames()
    for name, run in FLEET.items():
        rx = JaxRx(J.RxConfig(**FLEET_CFG), 2, use_pallas=False,
                   chunk_samples=FLEET_CHUNK, native=False, **run["seg"])
        out["fleet " + name] = _fleet_drive(rx, frames, save_before=6)
    return out


@pytest.fixture(scope="module")
def jax(tmp_path_factory):
    """The JAX results, computed in a child process started at the first
    request; call it to wait for them."""
    dst = tmp_path_factory.mktemp("jax_exact_rx") / "out.pkl"
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
            log = proc.communicate(timeout=1200)[0].decode(errors="replace")
            assert proc.returncode == 0, log[-3000:]
            got.update(pickle.loads(dst.read_bytes()))
        return got
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _assert_calls(want, got, tag):
    for k, (a, b) in enumerate(zip(want, got, strict=True)):
        for key in ("ts", "sample_backlog", "byte_backlog",
                    "mpegbyte_backlog"):
            np.testing.assert_array_equal(b[key], a[key],
                                          err_msg=f"{tag} call {k} {key}")
        for key in ("din", "dout"):
            assert len(a[key]) == len(b[key]), (tag, k, key)
            for u, w in zip(a[key], b[key]):
                for uu, ww in (zip(u, w) if key == "din" else [(u, w)]):
                    np.testing.assert_array_equal(
                        ww, uu, err_msg=f"{tag} call {k} {key}")
        for key, v in a["meas"].items():
            np.testing.assert_allclose(b["meas"][key], v, rtol=1e-4,
                                       atol=STATE_ATOL[key],
                                       err_msg=f"{tag} {key}")
        for key, v in a["dem"].items():
            w = b["dem"][key]
            if v.dtype.kind == "i":
                np.testing.assert_array_equal(w, v, err_msg=f"{tag} {key}")
                continue
            d = w.astype(np.float64) - v
            if key == "phase":                  # one turn is 65536
                d = (d + 32768) % 65536 - 32768
            assert (np.abs(d) <= 1e-4 * np.abs(v) + STATE_ATOL[key]).all(), \
                (tag, k, key, float(np.abs(d).max()))


def _port_dem(rx):
    return {k: v.numpy() for k, v in rx.state.items()}


def _port_rx(name):
    fields = SC[name][0]
    return T.DvbsReceiver(T.RxConfig(**(BASE | dict(exact_lut=False)
                                        | fields)), device="cpu")


def _port_fleet(name):
    return MultiDvbsReceiver(T.RxConfig(**FLEET_CFG), 2,
                             chunk_samples=FLEET_CHUNK, native=False,
                             device="cpu", **FLEET[name]["seg"])


@pytest.fixture(scope="module")
def port(jax):
    """Every cold-start run of the port, computed here while the JAX
    child (started first) runs: {name: (receiver, records, own
    checkpoint)}."""
    out = {}
    for name, (_, stim, calls) in SC.items():
        t = _port_rx(name)
        recs, _ = _drive(t, _stimulus(*stim, sum(calls)), calls, _port_dem)
        out[name] = (t, recs, None)
    frames = _fleet_frames()
    for name in FLEET:
        t = _port_fleet(name)
        recs, own = _fleet_drive(t, frames, save_before=6)
        out["fleet " + name] = (t, recs, own)
    return out


@pytest.mark.parametrize("name", list(SC))
def test_receiver_matches_jax(name, jax, port):
    t, got, _ = port[name]
    assert not t.use_pallas and t._planes is None
    if name == "exact rrc":
        assert (len(t.params.rrc_coeffs), t.params.rrc_steps) == (497, 53)
    if name == "hard-metric":
        assert set(t.tables["lut_cost"].tolist()) == {-1, 0}
    want, blob = jax()[name]
    _assert_calls(want, got, name)
    assert sum(len(r["ts"]) for r in got) >= 2 and t.lock, name
    # Resumed from the JAX checkpoint before the last call.
    calls = SC[name][2]
    r = _port_rx(name)
    r.load_state(from_jax_dvbs_checkpoint(blob))
    x = _stimulus(*SC[name][1], sum(calls))[sum(calls[:-1]):]
    resumed, _ = _drive(r, x, calls[-1:], _port_dem)
    _assert_calls(want[-1:], resumed, name + " resumed")


def _assert_fleet(want, got, tag):
    nts = 0
    for k, (a, b) in enumerate(zip(want, got, strict=True)):
        assert (a is None) == (b is None), f"{tag} chunk {k}"
        if a is None:
            continue
        assert a[1] == b[1], f"{tag} chunk {k}: decode shapes"
        np.testing.assert_array_equal(b[0], a[0],
                                      err_msg=f"{tag} chunk {k} packed")
        for c in range(2):
            np.testing.assert_array_equal(b[2][c], a[2][c],
                                          err_msg=f"{tag} chunk {k} TS")
            nts += len(a[2][c])
    return nts


@pytest.mark.parametrize("name", list(FLEET))
def test_fleet_matches_jax(name, jax, port):
    t, got, own = port["fleet " + name]
    assert not t.use_pallas and t.params.readahead == 10
    want, blob = jax()["fleet " + name]
    assert _assert_fleet(want, got, name) >= 4 and all(t.locks)
    # Resumed from the JAX checkpoint before the last two chunks (with
    # segments, from the port's own too: its dict seg_state).
    frames = _fleet_frames()[:, 6 * FLEET_CHUNK:]
    blobs = [("jax", from_jax_checkpoint(blob, rate="7/8"))]
    for tag, b in blobs + ([("own", own)] if FLEET[name]["seg"] else []):
        r = _port_fleet(name)
        r.load_state(b)
        if FLEET[name]["seg"]:
            assert isinstance(r._seg_state, dict)
            assert r._seg_state["mu"].shape == (16,)
        _assert_fleet(want[6:], _fleet_drive(r, frames)[0],
                      f"{name} resumed ({tag})")


if __name__ == "__main__":
    # The JAX side: python test_torch_exact_rx.py OUT.pkl
    Path(sys.argv[1]).write_bytes(pickle.dumps(jax_runs()))
