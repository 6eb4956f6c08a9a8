"""One run of one benchmark cell.

    python3 sdrbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout that holds BENCHMARK.json, this folder and
the program (leansdr_tpu_torch). It builds the cell's capture and
receiver from the seed (set-up, timed as setup_s), hands the receiver
its input for S seconds (the window), then checks what came out against
the benchmark's own reference, and prints one JSON line last on standard
output: correct, attempted, failed, the cell's end-to-end metrics (each
the quantity its name gives after the last dot: fleet.realtime_x is the
run's realtime_x) or, with --trace 1, its per-layer metrics (from a run
with spans and a short profiler trace), the device, and each number compared beside its limit
(also the last lines of standard error). It exits non-zero, with no
result line, without a CUDA device (or fewer than the cell asks for), or
if jax, jaxlib, flax or leansdr_tpu were ever imported.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from sdrbench.harness import (Cell, Profile, forbidden_modules,  # noqa: E402
                              load_json, result_line)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def judge(checks: dict, limits: dict) -> tuple:
    """Every number compared against its limit (a number at or under its
    limit passes; a missing or non-finite one fails). Returns (correct,
    {name: {value, limit}})."""
    out = {}
    ok = True
    for name, limit in limits.items():
        v = checks.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok &= good
        out[name] = {"value": v, "limit": limit}
    return ok, out


def run(args, cell: Cell) -> dict:
    """Set-up, window, check on the card; returns the result's fields."""
    import torch
    from sdrbench.peaks import card_info
    driver = cell.driver_module().Driver(cell.config, cell.traffic, args.seed,
                                         "cuda", trace=bool(args.trace))
    card = card_info()
    if args.trace:
        Profile.warm()
    driver.setup()
    setup_s = time.perf_counter() - T_START
    driver.window(args.seconds)
    e2e = driver.end_to_end()
    peak = torch.cuda.max_memory_allocated()
    driver.release()
    checks = driver.check()
    correct, judged = judge(checks, cell.config["limits"])
    e2e["diagnostics"] = getattr(driver, "diagnostics", None)
    values = dict(e2e, setup_s=setup_s)
    metrics = {}
    breakdown = None
    device_info = {"platform": "gpu", "kind": card["name"],
                   "count": int(cell.workload["chips"]),
                   "memory_peak_bytes": int(peak)}
    if args.trace:
        data = driver.per_layer_data()
        data["card"] = card
        for name, reader in cell.metric_readers().items():
            v = reader.read(data)
            if v is not None:
                unit = next(m["unit"] for m in cell.per_layer
                            if m["name"] == name)
                metrics[name] = {"value": float(v), "unit": unit}
        tr = data.get("trace")
        if tr:
            device_info["busy_s"] = tr["busy_s"]
            device_info["window_s"] = tr["window_s"]
            breakdown = {"device_ops": [[n, s] for n, s in tr["device_ops"]],
                         "idle_gaps": [[n, s] for n, s in tr["idle_gaps"]]}
            e2e["trace"] = dict(
                units=tr["units"], start_s=tr["start_s"], stop_s=tr["stop_s"],
                scopes_s={k: sum(v.values()) for k, v in tr["scopes"].items()})
    else:
        # An end-to-end metric is its cell's quantity named after the
        # last dot: fleet.realtime_x is the fleet cells' realtime_x.
        for m in cell.end_to_end:
            metrics[m["name"]] = {
                "value": float(values[m["name"].rsplit(".", 1)[-1]]),
                "unit": m["unit"]}
    attempted, failed = driver.counts()
    return dict(correct=correct, attempted=attempted, failed=failed,
                metrics=metrics, device=device_info, checks=judged,
                breakdown=breakdown, extra=dict(e2e, setup_s=setup_s,
                                                card=card))


def main(argv=None) -> int:
    args = parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    import torch
    bench = load_json(REPO / "BENCHMARK.json")
    cell = Cell(bench, args.workload)
    need = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    res = run(args, cell)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"forbidden modules were imported: {found}", file=sys.stderr)
        return 3
    print(json.dumps({"run": res["extra"]}), file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(result_line(res["correct"], res["attempted"], res["failed"],
                      res["metrics"], res["device"], res["checks"],
                      res["breakdown"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
