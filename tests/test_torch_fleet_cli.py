"""The port's fleet CLI, `python -m leansdr_tpu_torch.apps.leandvbfleet`,
on the plain versions of the kernels (--device cpu):

1. end to end in a subprocess: 2 interleaved f32 carriers at 1.2
   samples per symbol, rate 7/8 (the fewest samples per packet), with
   carrier offsets the --acq search removes, --chunk 4096, hard
   decisions with --fastlock, --fd-info: the tagged multiplex
   [u32 chan][u32 npkts][TS] parses, and from each channel's first sent
   packet on, every packet is the next one sent;
2. `-h` in a process where jax and leansdr_tpu cannot be imported;
3. parse_args against the JAX CLI's;
4. the flags of unported paths raise NotImplementedError naming their
   ROADMAP item before any input is read, those of ported item 10 reach
   the scan demod; --out-template opens one file per channel.

Tolerance: none (TS packets and parsed configurations are compared
exactly).
"""

import io
import struct
import sys

import numpy as np
import pytest
import torch
from scipy.signal import resample_poly

from leansdr_tpu_torch.pipelines import dvbs_tx, tsgen
from test_torch_leandvb import _run_jax_free

# Single-threaded torch, as in every port test file.
torch.set_num_threads(1)

NCHAN = 2
NSAMP = 32768
OFFSETS = (3.1e-4, -2.2e-4)          # cycles per sample


def _frames():
    """[NSAMP, NCHAN, 2] float32 sample-interleaved carriers: channel c
    sends packets from 500*c, at rate 7/8, resampled to 1.2 sps with its
    own delay, shifted by OFFSETS[c]."""
    rows = []
    for c in range(NCHAN):
        iq = dvbs_tx.modulate(tsgen.generate(42, start=500 * c),
                              dvbs_tx.TxConfig(rate="7/8", interp=2))
        z = resample_poly(iq[:, 0] + 1j * iq[:, 1], 6, 1)[3 + 4 * c::10]
        z = z[:NSAMP] * np.exp(2j * np.pi * OFFSETS[c] * np.arange(NSAMP))
        rows.append(np.stack([z.real, z.imag], -1))
    return np.stack(rows, axis=1).astype(np.float32)


def _demux(buf):
    got = [[] for _ in range(NCHAN)]
    o = 0
    while o < len(buf):
        c, k = struct.unpack_from("<II", buf, o)
        o += 8
        assert c < NCHAN and k > 0
        got[c].append(np.frombuffer(buf[o:o + k * 188], np.uint8)
                      .reshape(k, 188))
        o += k * 188
    assert o == len(buf)
    return [np.concatenate(g) if g else np.empty((0, 188), np.uint8)
            for g in got]


def test_fleet_cli_decodes_alone(tmp_path):
    info = tmp_path / "info.txt"
    code = (
        "import os, runpy\n"
        f"fd = os.open({str(info)!r}, os.O_WRONLY | os.O_CREAT)\n"
        f"sys.argv = ['leandvbfleet', '--nchan', '{NCHAN}', '--f32', "
        "'--float-scale', '75', '-f', '2.4e6', '--sr', '2e6', '--cr', "
        "'7/8', '--fastlock', '--acq', '--chunk', '4096', '--fd-info', "
        "str(fd), '--device', 'cpu']\n"
        "runpy.run_module('leansdr_tpu_torch.apps.leandvbfleet', "
        "run_name='__main__')\n")
    r = _run_jax_free(code, stdin=_frames().tobytes())
    ts = _demux(r.stdout)
    for c in range(NCHAN):
        sent = tsgen.generate(42, start=500 * c)
        hits = [int(np.nonzero((sent == p).all(axis=1))[0][0])
                if (sent == p).all(axis=1).any() else -1 for p in ts[c]]
        assert any(h >= 0 for h in hits), f"channel {c}: nothing sent"
        good = hits[next(i for i, h in enumerate(hits) if h >= 0):]
        assert len(good) >= 4 and good == list(
            range(good[0], good[0] + len(good))), (c, hits)
    lines = info.read_text().splitlines()
    assert lines and lines[0].startswith("FLEETLOCKS ")
    assert any(ln.startswith("FLEETMER ") for ln in lines)


def test_fleet_cli_help_runs_without_jax():
    code = ("sys.argv = ['leandvbfleet', '-h']\n"
            "import runpy\n"
            "runpy.run_module('leansdr_tpu_torch.apps.leandvbfleet', "
            "run_name='__main__')\n")
    r = _run_jax_free(code)
    out = r.stdout.decode()
    assert out.startswith("Usage: leandvbfleet") and "--device" in out


ARGVS = [
    ["--nchan", "4"],
    ["--nchan", "64", "--u8", "-f", "2.4e6", "--sr", "2e6", "--cr", "3/4",
     "--chunk", "262144", "--acq", "--fd-info", "2"],
    ["--nchan", "3", "--s16", "--float-scale", "75", "--sampler", "rrc",
     "--viterbi", "--fastlock", "--out-template", "x_%d.ts", "--segments",
     "8", "--tune", "5e3", "--drift", "--roll-off", "0.25"],
    ["--nchan", "2", "--hq", "--cr", "2/3", "--rrc-rej", "20",
     "--no-exact-lut", "--const", "QPSK"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a))
def test_fleet_cli_parse_args_matches_jax(argv):
    """The port's parse_args gives the JAX CLI's RxConfig (exact_lut
    aside: the port's default is False, the JAX one resolves None from
    its backend) and the same options, with `device` added."""
    from leansdr_tpu.apps import leandvbfleet as jcli
    from leansdr_tpu_torch.apps import leandvbfleet as tcli
    jc, jo = jcli.parse_args(list(argv))
    tc, to = tcli.parse_args(list(argv))
    a, b = dict(jc.__dict__), dict(tc.__dict__)
    assert b.pop("exact_lut") is False
    assert a.pop("exact_lut") in (None, False)
    assert a.pop("constellation").name == b.pop("constellation").name
    assert a == b
    assert to.pop("device") is None
    assert jo == to


@pytest.mark.parametrize("flags,item", [
    (["--exact-lut"], "item 10"), (["--sampler", "nearest"], "item 10"),
    (["--const", "8PSK", "--cr", "2/3", "--viterbi"], "item 20")])
def test_fleet_cli_unported_flags_raise(flags, item, monkeypatch):
    """The flags of items 10 and 20, once unported, reach their path: the
    CLI builds its fleet on the scan demod (--exact-lut with the default
    linear sampler, --sampler nearest with computed decisions) or, for
    --const 8PSK --cr 2/3, on the demod kernel with the 4/6 trellis's
    banked ACS (32 sync replicas per carrier), and one chunk of 2 x 1024
    frames goes through. A combination the JAX CLI refuses (8PSK at 1/2)
    raises its ValueError before stdin is read (a stdin that fails on
    read) and before a device is asked for (the default, CUDA)."""
    from leansdr_tpu_torch.apps import leandvbfleet
    from leansdr_tpu_torch.pipelines import multi_rx

    if item == "item 20":
        class NoRead:
            class buffer:
                def read(n=-1):
                    raise AssertionError("input read")
        with monkeypatch.context() as m:
            m.setattr(sys, "stdin", NoRead)
            with pytest.raises(ValueError, match="not suitable"):
                leandvbfleet.main(["--nchan", "2", "--const", "8PSK",
                                   "--viterbi"])
    built = []

    class Recorded(multi_rx.MultiDvbsReceiver):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    monkeypatch.setattr(multi_rx, "MultiDvbsReceiver", Recorded)
    iq = np.random.default_rng(0).standard_normal((1024, NCHAN, 2))

    class Stdin:
        buffer = io.BytesIO(iq.astype(np.float32).tobytes())
    monkeypatch.setattr(sys, "stdin", Stdin)
    monkeypatch.setattr(sys, "stdout", type("Out", (), {
        "buffer": io.BytesIO()}))
    assert leandvbfleet.main(["--nchan", "2", "--chunk", "1024",
                              "--device", "cpu"] + flags) == 0
    rx, = built
    assert rx._chunk_count == 1
    if item == "item 20":
        assert rx.use_pallas and rx.params.nsymbols == 8
        assert (rx.rate, rx.deconv.kind) == ("4/6", "viterbi_banked")
        assert rx.deconv.plan.nsyncs == 32
        return
    assert not rx.use_pallas and rx._planes is None
    assert rx.params.exact_lut == (flags == ["--exact-lut"])
    assert rx.params.sampler == ("nearest" if "nearest" in flags
                                 else "linear")
    assert rx.state["mu"].shape == (NCHAN,)


def test_fleet_cli_out_template(tmp_path, monkeypatch):
    """--out-template writes one file per channel (empty input: empty
    files) and nothing to stdout."""
    from leansdr_tpu_torch.apps import leandvbfleet
    out = io.BytesIO()
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(b"")))
    monkeypatch.setattr(sys, "stdout", io.TextIOWrapper(out))
    tpl = str(tmp_path / "ch_%d.ts")
    assert leandvbfleet.main(["--nchan", "3", "--out-template", tpl,
                              "--device", "cpu"]) == 0
    for c in range(3):
        assert (tmp_path / f"ch_{c}.ts").read_bytes() == b""
    assert out.getvalue() == b""
