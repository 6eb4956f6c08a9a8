"""The port's host apps against the JAX package's: leantsgen, leandvbtx
(and its streaming modulator TxStream), leansdrcat, leansdrserv and
leandvb_tui, as tests/test_apps_cli.py drives the JAX ones.

Tolerance: none. The CLIs write the same stdout bytes (and exit codes
and stderr) on the same input; TxStream over uneven packet batches
equals the batch `modulate`; leandvbtx's --fill reader gives what the
JAX one gives at each step of a non-blocking pipe.
"""

import io
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from leansdr_tpu.apps import leandvb_tui as jtui
from leansdr_tpu.apps import leandvbtx as jtx
from leansdr_tpu.apps import leantsgen as jgen
from leansdr_tpu.pipelines import dvbs_tx as JTX

from leansdr_tpu_torch.apps import leandvb_tui as ttui
from leansdr_tpu_torch.apps import leandvbtx as ttx
from leansdr_tpu_torch.apps import leantsgen as tgen
from leansdr_tpu_torch.dsp.cstln import Predef
from leansdr_tpu_torch.pipelines import dvbs_tx as TTX
from leansdr_tpu_torch.pipelines import tsgen

# Single-threaded torch, as in every port test file.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TS = 188


def _main(main, argv, stdin: bytes, monkeypatch, tmp_path, text=False):
    """main(argv) in this process with `stdin` (a file, so fileno()
    works) as its standard input; returns (exit code, stdout, stderr)."""
    src = tmp_path / "stdin.bin"
    src.write_bytes(stdin)
    out, err = io.BytesIO(), io.StringIO()
    with open(src, "rb") as f:
        if text:
            monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(f))
            monkeypatch.setattr(sys, "stdout", out := io.StringIO())
        else:
            monkeypatch.setattr(sys, "stdin", type("In", (), {"buffer": f}))
            monkeypatch.setattr(sys, "stdout",
                                type("Out", (), {"buffer": out}))
        monkeypatch.setattr(sys, "stderr", err)
        rc = main(list(argv))
    monkeypatch.undo()
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv", [["-c", "0"], ["-c", "1"], ["-c", "2500"],
                                  ["-x"]], ids=" ".join)
def test_leantsgen_matches_jax(argv, monkeypatch, tmp_path):
    want = _main(jgen.main, argv, b"", monkeypatch, tmp_path)
    got = _main(tgen.main, argv, b"", monkeypatch, tmp_path)
    assert got == want
    if argv[0] == "-c":
        assert len(got[1]) == int(argv[1]) * TS


TX_ARGV = [
    ["-f", "2", "--cr", "1/2"],
    ["-f", "2", "--cr", "3/4"],
    ["-f", "7/5", "--cr", "1/2", "--roll-off", "0.25"],
    ["-f", "7/5", "--cr", "3/4", "--power", "37.5", "--agc", "--s16"],
    ["-f", "4", "--cr", "2/3", "--power", "-3", "--agc", "--rrc-rej", "12"],
    ["--const", "8PSK", "--cr", "2/3", "-f", "3", "--s16"],
    ["--cr", "5/6", "--f32", "-v"],
    ["--cr", "9/10"],
    ["--bogus"],
]


@pytest.mark.parametrize("argv", TX_ARGV, ids=" ".join)
def test_leandvbtx_matches_jax(argv, monkeypatch, tmp_path):
    """leandvbtx, port against JAX, on the same 300 TS packets from
    stdin (more than one 64-packet read): the same exit code, IQ bytes
    and stderr."""
    ts = tsgen.generate(300).tobytes()
    want = _main(jtx.main, argv, ts, monkeypatch, tmp_path)
    got = _main(ttx.main, argv, ts, monkeypatch, tmp_path)
    assert got == want
    assert want[0] != 0 or len(want[1]) > 100000


def test_txstream_feed_matches_batch_modulate():
    """TxStream.feed over uneven packet batches (empty ones too): the
    concatenated output equals one batch `modulate` and JAX's TxStream,
    at a punctured rate with decimation and the AGC."""
    pk = tsgen.generate(120, start=7)
    for kw in (dict(rate="1/2", interp=2),
               dict(rate="3/4", interp=7, decim=5, agc=True,
                    amp=TTX.power_to_amp(37.5)),
               dict(rate="2/3", constellation=Predef.PSK8, interp=3)):
        t = TTX.TxStream(TTX.TxConfig(**kw))
        j = JTX.TxStream(JTX.TxConfig(**kw))
        got = []
        for lo, hi in ((0, 1), (1, 1), (1, 14), (14, 15), (15, 77),
                       (77, 120)):
            a, b = t.feed(pk[lo:hi]), j.feed(pk[lo:hi])
            np.testing.assert_array_equal(a, b)
            got.append(a)
        np.testing.assert_array_equal(np.concatenate(got),
                                      TTX.modulate(pk, TTX.TxConfig(**kw)))
    assert TTX.power_to_amp(37.5) == JTX.power_to_amp(37.5)


def test_read_packets_fill_matches_jax():
    """leandvbtx's --fill reader on a non-blocking pipe, step by step,
    against the JAX one (no timing): an empty pipe gives one blank
    packet; 3 written packets give those 3; a partial packet stays
    queued (a blank packet meanwhile) and completes with the next
    bytes; EOF gives eof."""
    pk = tsgen.generate(5).tobytes()
    blank = bytes([0x47]) + bytes(TS - 1)
    # One pipe and one buffer per reader, given the same writes.
    readers = {"jax": jtx._read_packets, "port": ttx._read_packets}
    pipes = {name: os.pipe() for name in readers}
    bufs = {name: bytearray() for name in readers}
    for r, _ in pipes.values():
        os.set_blocking(r, False)

    def step(write=b""):
        out = {}
        for name, fn in readers.items():
            r, w = pipes[name]
            if write:
                os.write(w, write)
            p, eof = fn(r, bufs[name], max_packets=64, fill=True)
            out[name] = (p.tobytes(), eof, bytes(bufs[name]))
        assert out["port"] == out["jax"]
        return out["port"]

    try:
        assert step() == (blank, False, b"")
        assert step(pk[:3 * TS]) == (pk[:3 * TS], False, b"")
        assert step(pk[3 * TS:3 * TS + 100]) == (blank, False,
                                                 pk[3 * TS:3 * TS + 100])
        assert step(pk[3 * TS + 100:]) == (pk[3 * TS:], False, b"")
        for _, w in pipes.values():
            os.close(w)
        assert step() == (b"", True, b"")
    finally:
        for r, w in pipes.values():
            for fd in (r, w):
                try:
                    os.close(fd)
                except OSError:
                    pass


# ------------------------------------------- as tests/test_apps_cli.py

def test_leansdrcat_paces_cbr():
    data = bytes(range(256)) * 64            # 16 KiB
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "leansdr_tpu_torch.apps.leansdrcat",
         "--cbr8", "32768"],                  # 32 KiB/s -> ~0.5 s
        input=data, capture_output=True, timeout=60, cwd=str(REPO))
    dt = time.perf_counter() - t0
    assert r.returncode == 0
    assert r.stdout == data                   # byte-transparent
    assert dt >= 0.3                          # actually paced


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_leansdrserv_info_httpd():
    port = _free_port()
    # Child prints tagged info lines on fd 3 and data on stdout.
    child = ("import os, time, sys\n"
             "w = os.fdopen(3, 'w', buffering=1)\n"
             "for k in range(50):\n"
             "    w.write('MER %d\\n' % k)\n"
             "    sys.stdout.write('x'); sys.stdout.flush()\n"
             "    time.sleep(0.05)\n")
    p = subprocess.Popen(
        [sys.executable, "-m", "leansdr_tpu_torch.apps.leansdrserv",
         "--info3-httpd", str(port), sys.executable, "-u", "-c", child],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, cwd=str(REPO))
    try:
        body = None
        for _ in range(40):
            time.sleep(0.25)
            try:
                body = urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/", timeout=2).read()
                if b"MER" in body:
                    break
            except OSError:
                continue
        assert body and b"MER" in body, body
        d = json.loads(body)
        assert "MER" in d and d["MER"]
    finally:
        p.terminate()
        p.wait(timeout=10)


def test_leansdrserv_data_and_control_httpd():
    d_port, c_port = _free_port(), _free_port()
    child = ("import os, sys, time\n"
             "ctl = os.fdopen(4, 'rb', buffering=0)\n"
             "req = ctl.readline()\n"
             "for _ in range(100):\n"
             "    sys.stdout.write('CTL=' + req.decode().split()[1])\n"
             "    sys.stdout.flush()\n"
             "    time.sleep(0.1)\n")
    p = subprocess.Popen(
        [sys.executable, "-m", "leansdr_tpu_torch.apps.leansdrserv",
         "--data1-httpd", str(d_port), "--control4-httpd", str(c_port),
         sys.executable, "-u", "-c", child],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, cwd=str(REPO))
    sock = None
    try:
        for _ in range(40):                     # wait for the listeners
            time.sleep(0.25)
            try:
                sock = socket.create_connection(
                    ("127.0.0.1", d_port), timeout=10)
                sock.sendall(b"GET / HTTP/1.0\r\n\r\n")
                break
            except OSError:
                sock = None
        assert sock is not None, "data listener never came up"
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{c_port}/tune?f=123", timeout=5).read()
        assert b"ECHO" in body
        data = b""
        while b"/tune?f=123" not in data and len(data) < 1 << 20:
            chunk = sock.recv(4096)
            assert chunk, data[-200:]
            data += chunk
        assert b"/tune?f=123" in data
    finally:
        if sock is not None:
            sock.close()
        p.terminate()
        p.wait(timeout=10)


INFO = ("STANDARD DVB-S\nCONSTELLATION QPSK\nCR 1/2\nSR 2000000\n"
        "SS 40.0\nMER 12.5\nLOCK 1\nLOCKTIME 150\nVBER 0.000130\n"
        "FREQ -1234\nlower case\nCNR 9.5\n")


def test_leandvb_tui_matches_jax(monkeypatch, tmp_path):
    """leandvb_tui renders the --fd-info tagged lines as the JAX one
    does (in this process, so both render once at the end and at the
    first line); and as a `python -m` process."""
    want = _main(jtui.main, [], INFO.encode(), monkeypatch, tmp_path,
                 text=True)
    got = _main(ttui.main, [], INFO.encode(), monkeypatch, tmp_path,
                text=True)
    assert got == want
    r = subprocess.run(
        [sys.executable, "-m", "leansdr_tpu_torch.apps.leandvb_tui"],
        input=INFO.encode(), capture_output=True, timeout=60, cwd=str(REPO))
    assert r.returncode == 0
    out = r.stdout.decode()
    assert out.endswith(want[1].split("\x1b[H\x1b[2J")[-1])
    assert "MER" in out and "12.5" in out and "#" in out
