"""The port's HDLC path against the JAX package: proto/hdlc.py (HdlcDec,
HdlcSync, the ETR192 scrambler and descrambler), DvbsReceiver's byte
stages with --hdlc, a short --hs --hdlc receiver run from a cold start
and resumed from a converted JAX checkpoint, and `leandvb --hdlc
--packetized` against the JAX CLI.

Tolerance: none. These stages are per-bit integer state machines in both
packages: frames, error counts, glyphs and every state field are equal.

The JAX receiver builds its HDLC stages only off the --hs path, so its
--hs --hdlc fails on its first bytes (the port builds them on both);
the --hs comparisons here give the JAX receiver the two fields its own
constructor gives the other paths.
"""

import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from leansdr_tpu.pipelines import dvbs_rx as JR
from leansdr_tpu.proto import hdlc as J
from test_hdlc import hdlc_encode     # flags, CRC16, bit stuffing

from leansdr_tpu_torch.apps import leandvb as tcli
from leansdr_tpu_torch.convert import from_jax_dvbs_checkpoint
from leansdr_tpu_torch.dsp import filtergen
from leansdr_tpu_torch.dsp.cstln import Predef, make_dvbs2_constellation
from leansdr_tpu_torch.fec import convenc
from leansdr_tpu_torch.pipelines import dvbs_rx as TR
from leansdr_tpu_torch.proto import hdlc as T

# Single-threaded torch, as in every port test file.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FMA_OFF = "--xla_cpu_max_isa=AVX"


def _frames(rng, n, lo=32, hi=256):
    return [rng.integers(0, 256, int(rng.integers(lo, hi + 1)),
                         dtype=np.uint8) for _ in range(n)]


def _stream(seed):
    """HDLC bytes with one inverted stretch and a few bit errors."""
    rng = np.random.default_rng(seed)
    s = hdlc_encode(_frames(rng, 40))
    s[len(s) // 3:len(s) // 2] ^= 0xFF
    for i in rng.integers(0, len(s), 12):
        s[i] ^= np.uint8(1 << int(rng.integers(0, 8)))
    return s


def _dec_state(d):
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in d.__dict__.items()}


def _sync_state(s):
    out = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
           for k, v in s.__dict__.items() if k != "decs"}
    out["decs"] = [_dec_state(d) for d in s.decs]
    return out


@pytest.mark.parametrize("invert", [False, True])
def test_hdlc_dec_matches_jax(invert):
    s = _stream(1)
    j, t = J.HdlcDec(2, 278, invert), T.HdlcDec(2, 278, invert)
    for lo, hi in ((0, 7), (7, 500), (500, len(s))):
        fj, hj, ej = j.decode(s[lo:hi])
        ft, ht, et = t.decode(s[lo:hi])
        assert (ht, et) == (hj, ej)
        assert len(ft) == len(fj)
        for a, b in zip(fj, ft):
            np.testing.assert_array_equal(b, a)
        assert _dec_state(t) == _dec_state(j)
    if not invert:
        assert len(ft) + len(fj) > 0


@pytest.mark.parametrize("fastlock,header16", [(True, False), (False, True),
                                               (True, True)])
def test_hdlc_sync_matches_jax(fastlock, header16, capsys):
    """Both polarities (the stream turns inverted for a stretch), with
    and without fastlock, with and without header16, in reads of uneven
    sizes; the -d glyphs too."""
    s = np.concatenate([_stream(2), _stream(3) ^ 0xFF, _stream(4)])
    j = J.HdlcSync(2, 278, fastlock=fastlock, header16=header16)
    t = T.HdlcSync(2, 278, fastlock=fastlock, header16=header16)
    j.debug = t.debug = True
    outs = []
    for lo, hi in ((0, 100), (100, 1777), (1777, 4000), (4000, len(s))):
        a = j.process(s[lo:hi])
        ja = capsys.readouterr().err
        b = t.process(s[lo:hi])
        tb = capsys.readouterr().err
        np.testing.assert_array_equal(b, a)
        assert tb == ja
        assert _sync_state(t) == _sync_state(j)
        outs.append(b)
    assert t.framecount > 40 and len(np.concatenate(outs)) > 4000
    assert t.cur_sync in (0, 1) and "_" in tb + ja


def test_etr192_matches_jax():
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, 3000, dtype=np.uint8)
    for fn in ("etr192_scramble", "etr192_descramble"):
        sj, cj, tj = 0, 0, 0
        st, ct = 0, 0
        for lo, hi in ((0, 1), (1, 999), (999, 3000)):
            a, sj, cj = getattr(J, fn)(data[lo:hi], sj, cj)
            b, st, ct = getattr(T, fn)(data[lo:hi], st, ct)
            np.testing.assert_array_equal(b, a)
            assert (st, ct) == (sj, cj)
    scr, _, _ = T.etr192_scramble(data)
    dsc, _, _ = T.etr192_descramble(scr)
    np.testing.assert_array_equal(dsc[4:], data[4:])  # self-synchronizing


def _jax_hs_hdlc(cfg):
    """The JAX receiver with --hs --hdlc, given the HDLC fields its
    constructor builds on the other paths (JAX dvbs_rx.py:355-360)."""
    j = JR.DvbsReceiver(cfg)
    if cfg.hdlc and not hasattr(j, "hdlc_sync"):
        j.hdlc_sync = J.HdlcSync(2, 278, fastlock=cfg.fastlock,
                                 header16=cfg.packetized)
        j.hdlc_sync.debug = cfg.debug
        j.etr_state = (0, 0)
    return j


@pytest.mark.parametrize("packetized", [False, True])
def test_byte_stages_hdlc_matches_jax(packetized):
    """_byte_stages with hdlc=True: the decoder's bytes through the
    ETR192 descrambler and the HDLC sync, in reads of uneven sizes
    (an empty one too): equal frames, descrambler state and sync."""
    rng = np.random.default_rng(6)
    frames = _frames(rng, 30)
    data, _, _ = T.etr192_scramble(hdlc_encode(frames))
    kw = dict(Fs=2.4e6, Fm=2e6, rate="1/2", anf=0, hdlc=True,
              packetized=packetized, fastlock=True)
    j = JR.DvbsReceiver(JR.RxConfig(**kw))
    t = TR.DvbsReceiver(TR.RxConfig(exact_lut=False, **kw), device="cpu")
    for lo, hi in ((0, 0), (0, 333), (333, 2000), (2000, len(data))):
        a = j._byte_stages(data[lo:hi])
        b = t._byte_stages(data[lo:hi])
        assert a.shape == b.shape == (0, 188)
        np.testing.assert_array_equal(t.hdlc_frames,
                                      getattr(j, "hdlc_frames", b""))
        assert t.etr_state == j.etr_state
        assert _sync_state(t.hdlc_sync) == _sync_state(j.hdlc_sync)
    assert t.hdlc_sync.header16 == packetized
    # Every frame but those still in the sync's backlog (it deframes in
    # whole chunks of 280 bytes) comes out, in order.
    sent = b"".join((bytes([len(f) >> 8, len(f) & 0xFF]) if packetized
                     else b"") + f.tobytes() for f in frames)
    out = t.hdlc_frames.tobytes()
    assert out in sent and len(out) > len(sent) - 2 * 280


# ------------------------------------------------------- the receiver

def hdlc_iq(frames, fs_up=6, fs_down=10, delay=3, f=0.0, seed=0):
    """HDLC frames -> ETR192 scrambler -> rate-1/2 convolutional code ->
    QPSK -> RRC (2 samples per symbol, roll-off 0.35) -> resampled by
    fs_up/fs_down with a fractional delay, shifted by f cycles per
    sample: [n, 2] float32, unit rms."""
    from scipy.signal import resample_poly
    data, _, _ = T.etr192_scramble(hdlc_encode(frames))
    syms, _ = convenc.encode(data, "1/2", 2)
    pts = make_dvbs2_constellation(Predef.QPSK, "1/2").symbols
    up = np.zeros(2 * len(syms), np.complex128)
    up[::2] = pts[syms, 0] + 1j * pts[syms, 1]
    taps = filtergen.root_raised_cosine(20, 0.5, 0.35)
    z = np.convolve(up, taps)
    z = resample_poly(z, fs_up, 1)[delay::fs_down]
    z = z * np.exp(2j * np.pi * f * np.arange(len(z)))
    z /= np.sqrt(np.mean(np.abs(z) ** 2) / 2)
    z += 0.05 * np.random.default_rng(seed).standard_normal(
        (len(z), 2)) @ np.array([1, 1j])
    return np.stack([z.real, z.imag], -1).astype(np.float32)


HS_READS = (6000, 6000, 4000)


def _hs_cfg(mod, **kw):
    return mod.RxConfig(Fs=2.4e6, Fm=2e6, rate="1/2", hs=True, anf=0,
                        fastlock=True, Finfo=500.0, hdlc=True,
                        packetized=True, **kw)


def _u8(x):
    """leandvb's u8 ingest of ~40 LSB rms: read_iq's u8 - 128."""
    return (np.clip(np.round(x * 40 + 128), 0, 255) - 128).astype(np.float32)


def _hs_read(rx, x, o, n):
    """One read through rx: its frames so far and its HDLC and decoder
    state."""
    ts = rx.process(x[o:o + n])
    assert ts.shape == (0, 188)
    return dict(frames=np.array(rx.hdlc_frames), etr=tuple(rx.etr_state),
                sync=_sync_state(rx.hdlc_sync), locked=rx.deconv.locked,
                backlog=np.array(rx.deconv.backlog))


def _same(want, got):
    for k, (a, b) in enumerate(zip(want, got, strict=True)):
        assert b["sync"] == a["sync"], k
        for key in ("frames", "etr", "locked", "backlog"):
            assert np.array_equal(b[key], a[key]), (k, key)


def _packets(out: bytes) -> list:
    """--packetized output: [u16 big-endian length][frame] ..."""
    frames, o = [], 0
    while o < len(out):
        n = out[o] << 8 | out[o + 1]
        frames.append(out[o + 2:o + 2 + n])
        o += 2 + n
    assert o == len(out)
    return frames


def test_receiver_hs_hdlc_matches_jax():
    """--hs --hdlc --packetized (u8 at 2.4 Msps, 2 Msym/s, fastlock)
    over three reads (16000 samples) from a cold start, and resumed from
    a JAX checkpoint written after the second read (etr_state and the
    HDLC sync's fields carried over): equal to the JAX receiver, frames
    out."""
    rng = np.random.default_rng(8)
    frames = _frames(rng, 36, 24, 64)
    x = _u8(hdlc_iq(frames, f=1e3 / 2.4e6)[:sum(HS_READS)])
    assert len(x) == sum(HS_READS)
    j = _jax_hs_hdlc(_hs_cfg(JR))
    want, blob, o = [], None, 0
    for k, n in enumerate(HS_READS):
        if k == 2:
            blob = j.save_state()
        want.append(_hs_read(j, x, o, n))
        o += n
    t = TR.DvbsReceiver(_hs_cfg(TR, exact_lut=False), device="cpu")
    got, o = [], 0
    for n in HS_READS:
        got.append(_hs_read(t, x, o, n))
        o += n
    _same(want, got)
    out = _packets(got[-1]["frames"].tobytes())
    assert len(out) >= 3 and all(f in {g.tobytes() for g in frames}
                                 for f in out)
    r = TR.DvbsReceiver(_hs_cfg(TR, exact_lut=False), device="cpu")
    r.load_state(from_jax_dvbs_checkpoint(blob))
    assert isinstance(r.hdlc_sync.decs[0], T.HdlcDec)
    r.hdlc_frames = np.array(want[1]["frames"])
    _same(want[2:], [_hs_read(r, x, sum(HS_READS[:2]), HS_READS[2])])
    # The port's own checkpoint round trip.
    u = TR.DvbsReceiver(_hs_cfg(TR, exact_lut=False), device="cpu")
    u.load_state(t.save_state())
    assert u.etr_state == t.etr_state
    assert _sync_state(u.hdlc_sync) == _sync_state(t.hdlc_sync)
    with pytest.raises(ValueError, match="hdlc"):
        TR.DvbsReceiver(TR.RxConfig(Fs=2.4e6, hs=True, anf=0,
                                    exact_lut=False),
                        device="cpu").load_state(t.save_state())


def test_leandvb_hdlc_packetized_matches_jax(monkeypatch, tmp_path):
    """`leandvb --hdlc --packetized -d` on u8 IQ (--exact-lut, --anf 0,
    --fastlock; 16000 samples): the port (in this process, --device cpu)
    writes the same frames to stdout and the same legend and glyphs to
    stderr as the JAX CLI (a child process, multiply-add contraction
    off)."""
    rng = np.random.default_rng(9)
    frames = _frames(rng, 36, 24, 64)
    x = hdlc_iq(frames, f=1e3 / 2.4e6, seed=1)[:16000]
    raw = (np.clip(np.round(x * 40 + 128), 0, 255).astype(np.uint8)
           .tobytes())
    argv = ["-f", "2.4e6", "--sr", "2e6", "--cr", "1/2", "--exact-lut",
            "--anf", "0", "--fastlock", "--hdlc", "--packetized", "-d"]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {FMA_OFF}")
    jax_cli = subprocess.Popen(
        [sys.executable, "-m", "leansdr_tpu.apps.leandvb"] + argv,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, cwd=REPO, env=env)
    try:
        src = tmp_path / "iq.u8"
        src.write_bytes(raw)
        out, err = io.BytesIO(), io.StringIO()
        with open(src, "rb") as f:
            monkeypatch.setattr(sys, "stdin", type("In", (), {"buffer": f}))
            monkeypatch.setattr(sys, "stdout",
                                type("Out", (), {"buffer": out}))
            monkeypatch.setattr(sys, "stderr", err)
            assert tcli.main(argv + ["--device", "cpu"]) == 0
        monkeypatch.undo()
    finally:
        jout, jerr = jax_cli.communicate(raw, timeout=900)
    assert jax_cli.returncode == 0, jerr.decode()[-3000:]
    assert out.getvalue() == jout
    assert err.getvalue() == jerr.decode()
    assert err.getvalue().startswith(
        "Output:\n  '_': HDLC frame with correct checksum\n")
    out = _packets(jout)
    assert len(out) >= 3 and all(f in {g.tobytes() for g in frames}
                                 for f in out)
