"""The open-loop sweep that finds the highest number of carriers a
configuration keeps up with (not run by the benchmark's own runs):

    python3 sdrbench/sweep.py --config dvbs-fleet-qpsk12 \\
        --traffic live-12db --carriers 64,96,128,192,256,320 \\
        --seconds 20 --seed N [--out FILE]

For each count, one run of the traffic mix at that many carriers, each
chunk handed over when the carriers' sample rate makes it due. A count is
sustained when the hand-overs of the window's last quarter ran late by
less than one chunk's period and by no more than those of its first
quarter plus half a period: the backlog did not grow. One JSON line per
count on standard output (and appended to FILE).
"""

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from sdrbench.harness import ROOT, load_json, load_module  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--carriers", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    cfg = load_json(ROOT / "configs" / f"{a.config}.json")
    base = load_json(ROOT / "traffic" / f"{a.traffic}.json")
    mod = load_module(ROOT / "drivers" / f"{cfg['driver']}.py",
                      "sdrbench_sweep_driver")
    period_ms = 1e3 * cfg["chunk_samples"] / cfg["receiver"]["Fs"]
    for n in (int(c) for c in a.carriers.split(",")):
        drv = mod.Driver(cfg, dict(base, carriers=n), a.seed, "cuda")
        drv.setup()
        drv.window(a.seconds)
        e = drv.end_to_end()
        drv.release()
        late = e["lateness_ms"]
        row = dict(carriers=n, realtime_x=e["realtime_x"],
                   latency_p95_ms=e["latency_p95_ms"],
                   latency_p50_ms=e["latency_p50_ms"], lateness_ms=late,
                   chunk_period_ms=period_ms, sustained=bool(
                       late and late[-1] < period_ms
                       and late[-1] <= late[0] + period_ms / 2))
        line = json.dumps(row)
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")
        del drv
    return 0


if __name__ == "__main__":
    sys.exit(main())
