"""The port's --hs receiver against the JAX one: the integer demod
(leansdr_tpu_torch.dsp.receiver_hs.run_chunks_hs_ref, the plain version of
csrc/hs_demod.cu) against leansdr_tpu.dsp.receiver_hs.run_chunks_hs, the
--hs deconvolver (_DeconvolSyncHS over fec/deconv.hs_sync_maps and
deconvolve_block/deconvolve_errors with symmap=) against JAX's, and
DvbsReceiver with hs=True (u8 IQ at 2.4 Msps, 2 Msym/s, rate 1/2,
fastlock) against JAX's DvbsReceiver, from a cold start and resumed from
a JAX checkpoint (convert.from_jax_dvbs_checkpoint).

The --hs path is integer arithmetic but for mu (float(d) * mu truncated,
mu + mucorr + omega): XLA has no multiply-add to contract there, so the
JAX side runs in this process.

Tolerance: none. Symbols, valid flags, freq, nmeas, sampled points and
every state field of the demod; the deconvolver's bytes and state; the
receiver's decoder inputs, bytes, TS packets, backlogs and FREQ
measurements are equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from leansdr_tpu.dsp import receiver_hs as J
from leansdr_tpu.fec import deconv as jdeconv
from leansdr_tpu.pipelines import dvbs_rx as JR, dvbs_tx, tsgen

from leansdr_tpu_torch.convert import from_jax_dvbs_checkpoint
from leansdr_tpu_torch.dsp import receiver_hs as T
from leansdr_tpu_torch.fec import deconv as tdeconv
from leansdr_tpu_torch.pipelines import dvbs_rx as TR
from leansdr_tpu_torch.util import trace

# Single-threaded torch, as in every port test file.
torch.set_num_threads(1)

C = 3


def _u8_stimulus(C, n, omega, seed=1, amp=40.0):
    """[C, n, 2] int32 u8 IQ values: random QPSK symbols at `omega`
    samples per symbol (linear interpolation at a fractional delay),
    carrier offsets, noise, centred on 128."""
    rng = np.random.default_rng(seed)
    out = []
    for c in range(C):
        nsym = int(n / omega) + 8
        s = ((rng.integers(0, 2, nsym) * 2 - 1)
             + 1j * (rng.integers(0, 2, nsym) * 2 - 1))
        t = np.arange(n) / omega + 0.3 + 0.2 * c
        z = (np.interp(t, np.arange(nsym), s.real)
             + 1j * np.interp(t, np.arange(nsym), s.imag))
        z = z * np.exp(2j * np.pi * 2e-3 * (c - 1) * np.arange(n)) * amp
        z += 5 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        out.append(np.stack([z.real, z.imag], -1))
    return np.clip(np.round(np.stack(out) + 128), 0, 255).astype(np.int32)


def test_hs_tables_match_jax():
    want = J.hs_tables()
    got = T.hs_tables("cpu")
    for k, a in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(a),
                                      err_msg=k)
    # The kernel's polar tables (rect16: tests/test_torch_scan_layout.py).
    np.testing.assert_array_equal(got["polar_a16"].numpy().astype(np.int32),
                                  np.asarray(want["polar_a"]))
    w = got["polar_w"].numpy()
    np.testing.assert_array_equal(((w & 0xFFFF) ^ 0x8000) - 0x8000,
                                  np.asarray(want["polar_a"]))
    np.testing.assert_array_equal(w >> 16, np.asarray(want["polar_r"]))
    a = T._hs_args(T.HsParams(omega=2.0))
    sc = [(int(want["sincos_re"][i]), int(want["sincos_im"][i]))
          for i in T.SINCOS_AT]
    assert list(zip(a.sc_re, a.sc_im)) == sc


@pytest.mark.parametrize("omega,freq0,drift", [(2.0, 0.0, False),
                                               (1.2, 3e-3, True)])
def test_run_chunks_hs_matches_jax(omega, freq0, drift):
    """Two calls of 5 chunks (the second from the first's end state);
    meas_decimation 300."""
    kw = dict(omega=omega, freq0=freq0, allow_drift=drift,
              meas_decimation=300)
    jp, tp = J.HsParams(**kw), T.HsParams(**kw)
    n = 5 * T.CHUNK
    x = _u8_stimulus(C, 2 * n + 1, omega)
    js, ts = J.init_state(jp, C), T.init_state(tp, C, "cpu")
    for k, v in js.items():
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(v))
    jt, tt = J.hs_tables(), T.hs_tables("cpu")
    for call in range(2):
        xs = x[:, call * n:(call + 1) * n + 1]
        js, jo = J.run_chunks_hs(jp, jt, js, jnp.asarray(xs))
        ts, to = T.run_chunks_hs(tp, tt, ts, torch.from_numpy(xs))
        assert set(jo) == set(to)
        for k, v in jo.items():
            a, b = np.asarray(v), to[k].numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(b, a, err_msg=f"{call} {k}")
        for k, v in js.items():
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(v),
                                          err_msg=f"{call} state {k}")
        assert to["valid"].sum() > C * n // 3 and to["nmeas"].sum() > 0
    assert trace.counters().get("launch.hs_demod", 0) == 0  # CPU: plain


@pytest.mark.parametrize("fastlock", [True, False])
def test_deconvol_sync_hs_matches_jax(fastlock):
    """The --hs deconvolver over one symbol stream in blocks of uneven
    size: the bytes, the locked map and the backlog equal JAX's; with
    symmap=, deconvolve_block and deconvolve_errors equal JAX's too."""
    rng = np.random.default_rng(5)
    syms = rng.integers(0, 4, 12000).astype(np.uint8)
    maps = tdeconv.hs_sync_maps()
    np.testing.assert_array_equal(maps, jdeconv.hs_sync_maps())
    for s in range(4):
        blk = syms[:800]
        np.testing.assert_array_equal(
            tdeconv.deconvolve_block(blk, "1/2", 0, symmap=maps[s]),
            jdeconv.deconvolve_block(blk, "1/2", 0, symmap=maps[s]))
        assert (tdeconv.deconvolve_errors(blk, "1/2", 0, symmap=maps[s])
                == jdeconv.deconvolve_errors(blk, "1/2", 0,
                                             symmap=maps[s]))
    j, t = JR._DeconvolSyncHS(fastlock), TR._DeconvolSyncHS(fastlock)
    o = 0
    for size in (100, 2000, 544, 3000, 777, 5579):
        a = j.process(syms[o:o + size])
        b = t.process(syms[o:o + size])
        np.testing.assert_array_equal(b, a)
        assert (t.locked, t.resync_phase) == (j.locked, j.resync_phase)
        np.testing.assert_array_equal(t.backlog, j.backlog)
        o += size


# ------------------------------------------------------------- receiver

CALLS = (16384, 16384, 4096)          # samples per process() call


def _rx_stimulus():
    """leandvb's u8 ingest of a 2 Msym/s rate-1/2 carrier at 2.4 Msps:
    the port's modulation x6, every 10th sample from the 3rd (a fractional
    delay), a 2 kHz offset, ~40 LSB, as read_iq gives it (u8 - 128)."""
    from scipy.signal import resample_poly
    iq = dvbs_tx.modulate(tsgen.generate(40),
                          dvbs_tx.TxConfig(rate="1/2", interp=2))
    z = resample_poly(iq[:, 0] + 1j * iq[:, 1], 6, 1)[3::10][:sum(CALLS)]
    z = z * np.exp(2j * np.pi * 2e3 / 2.4e6 * np.arange(len(z)))
    z *= 40 / np.sqrt(np.mean(np.abs(z) ** 2) / 2)
    x = np.clip(np.round(np.stack([z.real, z.imag], -1) + 128), 0, 255)
    return (x - 128).astype(np.float32)


def _cfg(mod, **kw):
    return mod.RxConfig(Fs=2.4e6, Fm=2e6, rate="1/2", hs=True, anf=0,
                        fastlock=True, Finfo=500.0, **kw)


def _record(rx, ts, dins, douts):
    return dict(ts=ts, din=list(dins), dout=list(douts),
                freq=list(rx.meas["freq"]),
                sample_backlog=np.array(rx.sample_backlog),
                byte_backlog=np.array(rx.byte_backlog),
                mpegbyte_backlog=np.array(rx.mpegbyte_backlog),
                hs_state={k: np.asarray(v) for k, v in rx.hs_state.items()})


def _capture(rx):
    dins, douts = [], []
    f = rx.deconv.process

    def wrap(s):
        dins.append(np.array(s))
        out = f(s)
        douts.append(np.array(out))
        return out
    rx.deconv.process = wrap
    return dins, douts


def _run(rx, x, calls):
    dins, douts = _capture(rx)
    recs, o = [], sum(CALLS[:len(CALLS) - len(calls)])
    for n in calls:
        ts = rx.process(x[o:o + n])
        recs.append(_record(rx, ts, dins, douts))
        dins.clear()
        douts.clear()
        o += n
    return recs


def _assert_same(want, got, tag):
    for k, (a, b) in enumerate(zip(want, got, strict=True)):
        for key in ("ts", "sample_backlog", "byte_backlog",
                    "mpegbyte_backlog"):
            np.testing.assert_array_equal(b[key], a[key],
                                          err_msg=f"{tag} call {k} {key}")
        for key in ("din", "dout"):
            assert len(a[key]) == len(b[key]), (tag, k, key)
            for u, w in zip(a[key], b[key]):
                np.testing.assert_array_equal(w, u, err_msg=f"{tag} {key}")
        assert a["freq"] == b["freq"], (tag, k)
        for key, v in a["hs_state"].items():
            np.testing.assert_array_equal(b["hs_state"][key], v,
                                          err_msg=f"{tag} {key}")


def test_receiver_hs_matches_jax():
    """--hs from a cold start over the three calls, and resumed from a
    JAX checkpoint after the second: equal to the JAX receiver, with TS
    packets out."""
    x = _rx_stimulus()
    j = JR.DvbsReceiver(_cfg(JR))
    jdins, jdouts = _capture(j)
    want, blob, o = [], None, 0
    for k, n in enumerate(CALLS):
        if k == 2:
            wrap = j.deconv.__dict__.pop("process")    # not pickled
            blob = j.save_state()
            j.deconv.process = wrap
        ts = j.process(x[o:o + n])
        want.append(_record(j, ts, jdins, jdouts))
        jdins.clear()
        jdouts.clear()
        o += n
    t = TR.DvbsReceiver(_cfg(TR, exact_lut=False), device="cpu")
    _assert_same(want, _run(t, x, CALLS), "cold")
    assert sum(len(r["ts"]) for r in want) >= 2 and t.lock
    r = TR.DvbsReceiver(_cfg(TR, exact_lut=False), device="cpu")
    r.load_state(from_jax_dvbs_checkpoint(blob))
    _assert_same(want[2:], _run(r, x, CALLS[2:]), "resumed")
    # The port's own checkpoint round trip carries the --hs state too.
    u = TR.DvbsReceiver(_cfg(TR, exact_lut=False), device="cpu")
    u.load_state(t.save_state())
    for k, v in t.hs_state.items():
        assert torch.equal(u.hs_state[k], v)
    assert (u.deconv.locked, u.deconv.resync_phase) == (
        t.deconv.locked, t.deconv.resync_phase)
