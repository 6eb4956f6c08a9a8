"""Readings that set the limits of a cell's comparison (not run by the
benchmark's own runs): for each seed, one run of the program and, in the
same process, the control, the reference at the precision below the
configuration's in the program's place; optionally the planted faults.

    python3 sdrbench/control.py --workload NAME --seeds 1,2,3 --seconds 3 \\
        [--control PRECISION] [--faults state,half,ts,dec,sym --fault-seeds 3] \\
        [--out FILE]

One JSON line per reading on standard output (and appended to FILE):
{"seed", "kind": "program" | "control" | "fault:<name>", numbers...}.
"""

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from sdrbench.harness import Cell, load_json  # noqa: E402


def reading(cell, seed, seconds, device, control=None, fault=None) -> list:
    drv = cell.driver_module().Driver(cell.config, cell.traffic, seed, device)
    if fault:
        drv.plant(fault)
    t = time.perf_counter()
    drv.setup()
    drv.window(seconds)
    e2e = drv.end_to_end()
    drv.release()
    out = dict(seed=seed, kind=f"fault:{fault}" if fault else "program",
               **drv.check(), realtime_x=e2e["realtime_x"],
               packets=e2e["packets"])
    out.update(getattr(drv, "diagnostics", None) or {})
    rows = [out]
    if control:
        rows.append(dict(seed=seed, kind=f"control:{control}",
                         **drv.control_check(control)))
    for r in rows:
        r["seconds"] = time.perf_counter() - t
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", default=None,
                   help="the control's precision (default: the "
                        "configuration's `control`)")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    cell = Cell(load_json(REPO / "BENCHMARK.json"), a.workload)
    seeds = [int(s) for s in a.seeds.split(",")]
    control = a.control or cell.config["control"]
    jobs = [(s, None) for s in seeds]
    jobs += [(s, f) for f in filter(None, a.faults.split(","))
             for s in seeds[:a.fault_seeds]]
    for seed, fault in jobs:
        for row in reading(cell, seed, a.seconds, a.device,
                           None if fault else control, fault):
            line = json.dumps(row)
            print(line, flush=True)
            if a.out:
                with open(a.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
