"""The port's multi-process fleet (leansdr_tpu_torch.parallel.multihost,
the counterpart of tools/dcn_demo.py, which tests/test_dcn.py runs) on 2
gloo ranks on the CPU: 4 carriers of QPSK 1/2 (Viterbi, fastlock), 2 per
rank, each rank modulating only its own carriers and feeding them
through DeviceFeeder, against the port's single-process
MultiDvbsReceiver over the same 4 carriers fed the same chunks.

Size: 8 chunks of 8192 samples per carrier (the first TS packets come
out after ~57k samples), the time-segmented demod at 16 segments from
the first chunk (seg_holdoff 0): the plain demod costs ~1 ms per sample
on the CPU, 16 lanes per carrier cut that ~3x. The launcher runs with a
FileStore under tmp_path (no fixed port), its own 60 s init timeout and
a whole-run timeout; this test kills its process group after
RUN_TIMEOUT_S.

Tolerance: none. Each carrier's TS is byte-equal to the single-process
fleet's, every carrier puts out packets, and every rank reports the same
reduced counts (decoded packets equal to the single-process fleet's).
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from leansdr_tpu_torch.parallel import multihost
from leansdr_tpu_torch.pipelines.multi_rx import MultiDvbsReceiver

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
RUN_TIMEOUT_S = 120
FLEET = dict(nchan=4, chunk=8192, windows=8, segments=16, seg_warmup=256,
             seg_holdoff=0)


def test_two_rank_fleet_matches_single_process(tmp_path):
    out = tmp_path / "ts"
    argv = [sys.executable, "-m", "leansdr_tpu_torch.parallel.multihost",
            "--world", "2", "--backend", "gloo", "--device", "cpu",
            "--out", str(out), "--init", f"file://{tmp_path / 'store'}",
            "--timeout", str(RUN_TIMEOUT_S - 10)]
    for k, v in FLEET.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.Popen(argv, cwd=str(REPO), env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)
    try:
        # The single-process fleet, while the ranks run.
        C, chunk = FLEET["nchan"], FLEET["chunk"]
        rx = MultiDvbsReceiver(
            multihost.fleet_config(), C, chunk_samples=chunk, device="cpu",
            segments=FLEET["segments"], seg_warmup=FLEET["seg_warmup"],
            seg_holdoff=FLEET["seg_holdoff"])
        nsamp = FLEET["windows"] * chunk + rx.readahead
        iq = np.stack([multihost.carrier_iq(c, nsamp) for c in range(C)])
        ts = [[] for _ in range(C)]
        for win in multihost.windows(iq, chunk, rx.readahead, "cpu"):
            for c, p in enumerate(rx.process(win)):
                ts[c].append(p)
        want = [np.concatenate(t).tobytes() for t in ts]
        so, se = proc.communicate(timeout=RUN_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert proc.returncode == 0, (so + se)[-4000:]
    lines = [json.loads(l) for l in so.splitlines() if l.startswith("{")]
    assert [r["rank"] for r in lines] == [0, 1]
    for c in range(C):
        got = (out / f"ch_{c}.ts").read_bytes()
        assert len(got) and len(got) % 188 == 0, c
        assert got == want[c], f"carrier {c}: TS differs"
    decoded = sum(len(w) // 188 for w in want)
    for r in lines:
        assert r["world"] == 2 and r["backend"] == "gloo"
        assert r["fleet_decode_backend"] == "NativeByteBackend"
        assert r["fleet_ts_decoded"] == decoded
        assert r["rank_ts_decoded"] == sum(len(w) // 188
                                           for w in want[2 * r["rank"]:
                                                         2 * r["rank"] + 2])
        assert r["fleet_ts_verified"] >= C
        assert r["fleet_symbols_sum"] > 0
        assert r["fir_msamples_per_s"] > 0
        for k in ("fleet_symbols_sum", "fleet_mer_mean_db",
                  "fleet_ts_verified", "fleet_aggregate_msamples_per_s"):
            assert r[k] == lines[0][k], k
    # Stage 1's MER is a group mean: the same on both ranks, finite.
    assert np.isfinite(lines[0]["fleet_mer_mean_db"])


def test_launcher_refuses_nccl_on_the_cpu(capsys):
    with pytest.raises(SystemExit):
        multihost.parse_args(["--world", "2", "--device", "cpu"])
    assert "gloo" in capsys.readouterr().err
