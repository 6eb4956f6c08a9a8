"""The port's leaniio (leaniiorx / leaniiotx on the simulated AD936x
backend), util/ad936x.py and util/pmp.py against the JAX package's, on
the cases tests/test_iio.py drives. The leanmlmrx consumer of --pmp is
not ported yet (ROADMAP queue 1 item 15).

Tolerance: none. Rate plans, FIR taps and config text, descriptors and
the apps' stdout bytes, stderr lines, exit codes and sink files are
equal.
"""

import io
import re
import struct
import sys

import numpy as np
import pytest

from leansdr_tpu.apps import leaniio as jio
from leansdr_tpu.util import ad936x as JA
from leansdr_tpu.util import pmp as JP

from leansdr_tpu_torch.apps import leaniio as tio
from leansdr_tpu_torch.util import ad936x as TA
from leansdr_tpu_torch.util import pmp as TP


def _main(main, argv, monkeypatch, stdin=b""):
    """main(argv) in this process; returns (exit code, stdout, stderr)."""
    out, err = io.BytesIO(), io.StringIO()
    monkeypatch.setattr(sys, "stdin",
                        type("In", (), {"buffer": io.BytesIO(stdin)}))
    monkeypatch.setattr(sys, "stdout", type("Out", (), {"buffer": out}))
    monkeypatch.setattr(sys, "stderr", err)
    try:
        rc = main(list(argv))
    except SystemExit as e:
        rc = e.code
    monkeypatch.undo()
    return rc, out.getvalue(), err.getvalue()


def _both(argv, monkeypatch, stdin=b""):
    want = _main(jio.main, argv, monkeypatch, stdin)
    got = _main(tio.main, argv, monkeypatch, stdin)
    assert got == want
    return got


@pytest.mark.parametrize("fs", [61.44e6, 25e6, 2.5e6, 2083333, 2083332,
                                1e6, 520833, 520832, 400e3, 62e6])
def test_rate_plan_matches_jax(fs):
    try:
        want = JA.plan_rate(fs)
    except JA.RatePlanError as e:
        with pytest.raises(TA.RatePlanError, match=re.escape(str(e))):
            TA.plan_rate(fs)
        return
    got = TA.plan_rate(fs)
    assert (got.fs, got.use_fir, got.factor, got.converter_fs) == \
        (want.fs, want.use_fir, want.factor, want.converter_fs)


def test_fir_config_and_taps_match_jax():
    for n in (16, 32, 64, 128):
        np.testing.assert_array_equal(TA.quarter_band_taps(n),
                                      JA.quarter_band_taps(n))
    taps = TA.quarter_band_taps()
    for direction, factor, t in (("RX", 4, taps), ("TX", 4, taps[:32]),
                                 ("tx", 1, taps[:16])):
        text = TA.fir_config(direction, factor, t)
        assert text == JA.fir_config(direction, factor, t)
        d, f, back = TA.parse_fir_config(text)
        jd, jf, jback = JA.parse_fir_config(text)
        assert (d, f) == (jd, jf) == (direction.upper(), factor)
        np.testing.assert_array_equal(back, jback)
    assert text.startswith("TX 3 GAIN 0 INT 1\n")
    _, _, back = TA.parse_fir_config(TA.fir_config("RX", 4, taps))
    np.testing.assert_array_equal(back, taps)
    for bad in (lambda: TA.quarter_band_taps(40),
                lambda: TA.fir_config("XX", 4, taps),
                lambda: TA.fir_config("RX", 4, taps[:20])):
        with pytest.raises(ValueError):
            bad()


def test_quarter_band_response():
    t = TA.quarter_band_taps().astype(np.float64)
    H = 20 * np.log10(np.abs(np.fft.rfft(t / t.sum(), 4096)) + 1e-12)
    f = np.linspace(0, 0.5, len(H))
    assert abs(H[np.argmin(abs(f - 0.05))]) < 0.5      # passband flat
    assert H[(f > 0.2)].max() < -40                    # quarter-band image


def test_leaniiorx_tone_capture_matches_jax(monkeypatch):
    rc, out, err = _both(["rx", "-s", "2.5e6", "--bufsize", "4096",
                          "--count", "2", "--sim", "tone:100e3", "-v", "-d"],
                         monkeypatch)
    assert rc == 0
    iq = np.frombuffer(out, np.int16).reshape(-1, 2)
    assert len(iq) == 2 * 4096
    z = iq[:, 0].astype(np.float64) + 1j * iq[:, 1]
    fpk = np.argmax(np.abs(np.fft.fft(z))) / len(z) * 2.5e6
    assert abs(fpk - 100e3) < 2.5e6 / 4096
    assert "Setting sampling rate 2500 kHz" in err


def test_leaniiorx_fir_decimator_low_rate_matches_jax(monkeypatch):
    # 1 Msps needs the FIR /4 path: the converter runs at 4 Msps, and a
    # 1.4 MHz tone (out of band after decimation) comes out attenuated.
    _, stop, err = _both(["rx", "-s", "1e6", "--bufsize", "4096",
                          "--count", "2", "--sim", "tone:1.4e6", "-v"],
                         monkeypatch)
    _, pas, _ = _both(["rx", "-s", "1e6", "--bufsize", "4096", "--count",
                       "2", "--sim", "tone:100e3"], monkeypatch)
    assert "FIR decimator /4" in err
    a_stop = np.abs(np.frombuffer(stop, np.int16).astype(np.float64)).mean()
    a_pass = np.abs(np.frombuffer(pas, np.int16).astype(np.float64)).mean()
    assert len(stop) == 2 * 4096 * 4
    assert a_stop < a_pass / 30


@pytest.mark.parametrize("argv,msg", [
    (["rx", "-s", "100e6", "--sim", "tone:1e3"], "too high"),
    (["rx", "-s", "100e3", "--sim", "tone:1e3"], "FPGA decimation"),
    (["tx", "-s", "100e3", "--sim", "tone:1e3"], "FPGA decimation"),
    (["rx", "--bogus"], "unknown option"),
    (["rx", "-s", "2.5e6"], "libiio python bindings not installed"),
    (["xx"], "Usage")])
def test_leaniio_rejects_match_jax(argv, msg, monkeypatch):
    """Unplannable rates, unknown flags, no --sim without the iio
    bindings, no subcommand: the same exit code, stdout and stderr as
    the JAX app (the usage text is each module's docstring)."""
    want = _main(jio.main, argv, monkeypatch)
    got = _main(tio.main, argv, monkeypatch)
    assert got[:2] == want[:2] and got[0] == 1
    assert msg in got[2] and msg in want[2]
    if msg != "Usage":
        assert got[2] == want[2]


def test_leaniio_version(monkeypatch, capsys):
    with pytest.raises(SystemExit) as e:
        tio.main(["rx", "--version"])
    assert e.value.code == 0
    assert capsys.readouterr().out == "leansdr_tpu_torch\n"


def test_leaniiotx_interpolator_matches_jax(tmp_path, monkeypatch):
    # TX at 1 Msps engages the INT-4 FIR; the sink holds the 4 Msps
    # converter-rate signal with the baseband tone kept.
    n = 8192
    t = np.arange(n)
    iq = np.empty((n, 2), np.int16)
    iq[:, 0] = np.round(8000 * np.cos(2 * np.pi * 0.02 * t))
    iq[:, 1] = np.round(8000 * np.sin(2 * np.pi * 0.02 * t))
    sinks = []
    for main, name in ((jio.main, "jax"), (tio.main, "port")):
        sink = tmp_path / f"{name}.iq"
        r = _main(main, ["tx", "-s", "1e6", "--bufsize", "4096", "--sim",
                         f"file:{sink}", "-v", "-d"], monkeypatch,
                  iq.tobytes())
        assert r[0] == 0 and "FIR interpolator x4" in r[2]
        sinks.append((r, sink.read_bytes()))
    assert sinks[0] == sinks[1]
    out = np.frombuffer(sinks[1][1], np.int16).reshape(-1, 2)
    assert len(out) > 3 * n
    z = out[:, 0].astype(np.float64) + 1j * out[:, 1]
    fpk = np.argmax(np.abs(np.fft.fft(z))) / len(z)
    assert abs(fpk - 0.005) < 2.0 / len(z)


def test_pmp_descriptor_wire_format_matches_jax():
    # 4 little-endian u64s, canary = the buffer's first u64
    # (leaniiorx.cc:132-144, leanmlmrx.cc:359-369).
    assert TP.DESC_SIZE == JP.DESC_SIZE == 32
    assert TP.PMP_MAGIC == JP.PMP_MAGIC
    buf = struct.pack("<Q", 0xFEEDFACECAFEF00D) + b"x" * 56
    d = TP.make_descriptor(buf, physaddr=0x10000)
    raw = d.pack()
    assert raw == JP.make_descriptor(buf, physaddr=0x10000).pack()
    assert d.canary == 0xFEEDFACECAFEF00D and d.size == 64
    assert raw[:8] == struct.pack("<Q", TP.PMP_MAGIC)
    back = TP.parse(raw)
    assert (back.physaddr, back.size, back.canary) == \
        (0x10000, 64, 0xFEEDFACECAFEF00D)
    with pytest.raises(ValueError):
        TP.parse(b"\0" * 32)
    with pytest.raises(ValueError):
        TP.make_descriptor(b"short", 0)


def test_leaniiorx_pmp_publish_and_recycle_matches_jax(tmp_path,
                                                       monkeypatch):
    runs = {}
    for main, name in ((jio.main, "jax"), (tio.main, "port")):
        devmem = tmp_path / f"cma_{name}"
        r = _main(main, ["rx", "-s", "2.5e6", "--bufsize", "1024",
                         "--count", "6", "--nbufs", "4", "--pmp",
                         "--devmem", str(devmem), "--sim", "tone:200e3"],
                  monkeypatch)
        assert r[0] == 0, r[2]
        runs[name] = (r, devmem.read_bytes())
    assert runs["port"] == runs["jax"]
    out = runs["port"][0][1]
    devmem = tmp_path / "cma_port"
    descs = [TP.parse(out[i:i + TP.DESC_SIZE])
             for i in range(0, len(out), TP.DESC_SIZE)]
    assert len(descs) == 6
    # The last ring generation's descriptors map and validate, and
    # continue the same tone.
    samples = []
    for d in descs[2:]:
        buf = TP.map_buffer(d, devmem=str(devmem))
        assert d.size == 1024 * 4
        samples.append(np.frombuffer(buf, np.int16).reshape(-1, 2))
    z = np.concatenate(samples)[:, 0].astype(np.float64)
    fpk = np.argmax(np.abs(np.fft.fft(z))) / len(z) * 2.5e6
    assert abs(fpk - 200e3) < 2.5e6 / len(z) * 2
    # Descriptor 0's slot was recycled by buffer 4: its canary fails.
    with pytest.raises(ValueError):
        TP.map_buffer(descs[0], devmem=str(devmem))
