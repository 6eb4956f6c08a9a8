"""The benchmark's machinery, shared by every cell: finding a cell's
configuration, traffic mix, driver and per-layer metrics by name, the
window every driver runs (StreamDriver), spans and profiler scopes around
calls into the program, reducing a profiler trace, and the result line.

A cell is an entry of BENCHMARK.json's `workloads`. Its `config` names
`configs/<config>.json`, which names a driver, `drivers/<driver>.py`; its
`traffic` names `traffic/<traffic>.json`; each per-layer metric is
`metrics/<metric>.py`. New cells, mixes and metrics are new files.
"""

import importlib.util
import json
import time
from pathlib import Path

from sdrbench import check

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "leansdr_tpu")
SCOPE = "sdrbench."             # the names of the benchmark's profiler scopes


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the file `path` as a module named `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _safe(name: str) -> str:
    return "sdrbench_" + "".join(ch if ch.isalnum() else "_" for ch in name)


class Cell:
    """One workload of a benchmark file, with its configuration, traffic
    mix and per-layer metrics resolved by name under `root`."""

    def __init__(self, bench: dict, workload: str, root: Path = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r}: {sorted(cells)}")
        self.root = root
        self.workload = cells[workload]
        self.config = load_json(root / "configs" / f"{self.workload['config']}.json")
        self.traffic = load_json(root / "traffic" / f"{self.workload['traffic']}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in bench["per_layer"]
                          if workload in m.get("workloads", [workload])]

    def driver_module(self):
        name = self.config["driver"]
        return load_module(self.root / "drivers" / f"{name}.py",
                           _safe("driver_" + name))

    def metric_readers(self) -> dict:
        return {m["name"]: load_module(self.root / "metrics" /
                                       f"{m['name']}.py",
                                       _safe("metric_" + m["name"]))
                for m in self.per_layer}


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name, compared whole, is one the
    benchmark must never load."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


# ------------------------------------------------------------------- spans

class Patches:
    """Module and instance attributes replaced for a run, restored on
    close."""

    def __init__(self):
        self.saved = []

    def set(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def close(self):
        for obj, name, value in reversed(self.saved):
            setattr(obj, name, value)
        self.saved.clear()


class Spans:
    """Host-clock spans by name, per input (chunk or read), and profiler
    scopes, recorded by wrappers the driver puts around calls into the
    program while a traced run is on."""

    def __init__(self):
        self.host = {}             # name -> [(unit, ms)]
        self.unit = -1

    def host_span(self, name, fn):
        def wrapper(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.host.setdefault(name, []).append(
                    (self.unit, (time.perf_counter() - t) * 1e3))
        return wrapper

    @staticmethod
    def scope(name, fn):
        """`fn` inside a profiler scope SCOPE + name: the profiler counts
        the device time of the kernels launched under it
        (reduce_trace's `scopes`)."""
        from torch.profiler import record_function

        def wrapper(*a, **kw):
            with record_function(SCOPE + name):
                return fn(*a, **kw)
        return wrapper

    def per_unit(self, units) -> dict:
        """{name: [ms summed per unit]} over the units in `units`."""
        keep = sorted(set(units))
        out = {}
        for name, rows in self.host.items():
            acc = {}
            for u, ms in rows:
                acc[u] = acc.get(u, 0.0) + ms
            out[name] = [acc.get(u, 0.0) for u in keep]
        return out


# ---------------------------------------------------------------- profiler

def _scope_kernels(e) -> list:
    """The device operations launched under host operation `e` and the
    operations inside it, outside the benchmark scopes inside it."""
    out = list(e.kernels)
    todo = list(e.cpu_children)
    while todo:
        c = todo.pop()
        if not c.name.startswith(SCOPE):
            out.extend(c.kernels)
            todo.extend(c.cpu_children)
    return out


def reduce_trace(prof, window_s: float) -> dict:
    """A torch.profiler run over a steady stretch -> device time by
    operation name; by benchmark scope, the device seconds of each
    operation the profiler links to a host operation under the scope and
    outside the scopes inside it (it links the kernels that torch
    operations launch; those a library launches outside any torch
    operation, as the program's own kernels through ctypes, it may not);
    the busy seconds (the union of the device operations' intervals), the
    longest idle gaps named by the shortest host operation that spans
    each gap's middle (Python between torch ops is no operation to the
    profiler), and the stretch's length; names cut to 120 characters."""
    from torch.autograd import DeviceType
    dev, host = [], []
    scopes = {}
    for e in prof.events():
        tr = e.time_range
        if e.name.startswith(SCOPE):
            # A scope's device-side annotation spans its kernels and the
            # gaps between them: no device operation.
            if e.device_type == DeviceType.CPU:
                acc = scopes.setdefault(e.name[len(SCOPE):], {})
                for k in _scope_kernels(e):
                    acc[k.name] = acc.get(k.name, 0.0) + k.duration * 1e-6
        elif e.device_type == DeviceType.CUDA:
            dev.append((tr.start, tr.end, e.name))
        elif e.device_type == DeviceType.CPU:
            host.append((tr.start, tr.end, e.name))
    ops = {}
    calls = {}
    for s, t, name in dev:
        ops[name] = ops.get(name, 0.0) + (t - s) * 1e-6
        calls[name] = calls.get(name, 0) + 1
    dev.sort()
    merged = []
    for s, t, _ in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged) * 1e-6
    gaps = sorted(((s1 - t0, t0, s1) for (_, t0), (s1, _)
                   in zip(merged, merged[1:])), reverse=True)[:10]
    named = []
    for g, t0, s1 in gaps:
        mid = (t0 + s1) / 2
        spans = [(t - s, name) for s, t, name in host if s <= mid <= t]
        named.append((min(spans)[1] if spans else "host, outside any op",
                      g * 1e-6))
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    return dict(ops=ops, calls=calls, scopes=scopes, busy_s=busy,
                window_s=window_s,
                device_ops=[(n[:120], t) for n, t in top],
                idle_gaps=[(n[:120], t) for n, t in named],
                traced=bool(dev))


class Profile:
    """torch.profiler over a steady stretch of a traced run, from input
    `first` to the input stop() names."""

    def __init__(self, first: int):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        t = time.perf_counter()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.first, self.end = first, None
        self.t = time.perf_counter()
        self.start_s = self.t - t

    @staticmethod
    def warm():
        """Start and stop the profiler once over one small operation, so
        that its one-time start-up falls in set-up, not in the window."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def stop(self, unit: int):
        import torch
        torch.cuda.synchronize()
        self.end = unit
        t = time.perf_counter()
        self.window_s = t - self.t
        self.prof.__exit__(None, None, None)
        self.stop_s = time.perf_counter() - t

    def reduce(self) -> dict:
        tr = reduce_trace(self.prof, self.window_s)
        tr.update(units=(self.first, self.end), start_s=self.start_s,
                  stop_s=self.stop_s)
        return tr


# ------------------------------------------------------------------ window

class StreamDriver:
    """What every driver shares: one run of a cell's stream of inputs.

    The run is setup() (the driver's), window(seconds), end_to_end(),
    release() (after the memory peak is read), then check() and, in a
    traced run, per_layer_data(). The window hands the program one input
    after another at the traffic's pace (`pace` "asap", as when decoding
    a capture, or "realtime", each input when the carriers' sample rate
    makes it due), dates every TS packet given back, and profiles a
    steady stretch of a traced run (`trace_from` inputs into the window,
    for `trace_inputs` inputs).

    A driver sets `step` (samples per carrier per input), `nchan` and
    `cap` (the stimulus.Capture), and supplies `_submit()`, which hands
    input `self.unit` over and returns the outputs that came back (a list
    of per-carrier lists of [k, 188] packets), and may supply `_drain()`
    (what is still held once the inputs end) and `_extras()` (more
    figures for the run's record)."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 trace: bool = False):
        import numpy as np
        import torch
        self.cfg = config
        self.traffic = traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        self.trace = trace
        self.rng = np.random.default_rng(self.seed)
        self.fs = float(config["receiver"]["Fs"])
        self.spans = Spans()
        self.patches = Patches()
        self.kernel_shapes = {}
        self.profile = None
        self.fault = None
        self.unit = 0                   # the input being handed over
        self.handover = []              # the time each input was handed over
        self.ledger = None
        self.window_first = None

    FAULTS = ()

    def plant(self, fault: str):
        """Break the timed path for the fault test (before setup())."""
        if fault not in self.FAULTS:
            raise ValueError(fault)
        self.fault = fault

    def _drain(self) -> list:
        return []

    def _extras(self) -> dict:
        return {}

    def hand_over(self, t_handover: float) -> list:
        """Hand input `self.unit` over, dated `t_handover`."""
        self.spans.unit = self.unit
        self.handover.append(t_handover)
        done = self._submit()
        self.unit += 1
        return done

    def window(self, seconds: float):
        """Hand inputs over for `seconds` at the traffic's pace, then
        drain. In a realtime mix input k of the window is due k input
        periods from its start, and its hand-over time is when it was
        due."""
        import torch
        realtime = self.traffic["pace"] == "realtime"
        period = self.step / self.fs
        self.window_first = self.unit
        self.ledger = check.PacketLedger(self.cap, self.nchan)
        prof_at = (self.window_first + self.cfg["trace_from"]
                   if self.trace else None)
        self.lateness = []
        t0 = time.perf_counter()
        while True:
            due = t0 + (self.unit - self.window_first) * period
            now = time.perf_counter()
            if realtime and now < due:
                time.sleep(due - now)
                now = time.perf_counter()
            if now - t0 >= seconds:
                break
            if self.unit == prof_at:
                self.profile = Profile(self.unit)
            self.lateness.append(now - due if realtime else 0.0)
            done = self.hand_over(due if realtime else now)
            t_r = time.perf_counter()
            for out in done:
                self.ledger.add(t_r, out)
            if (self.profile is not None and self.profile.end is None
                    and self.unit == prof_at + self.cfg["trace_inputs"]):
                self.profile.stop(self.unit)
        for out in self._drain():
            self.ledger.add(time.perf_counter(), out)
        self.t0, self.t_end = t0, time.perf_counter()
        if self.profile is not None and self.profile.end is None:
            self.profile.stop(self.unit)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.window_inputs = self.unit - self.window_first

    def end_to_end(self) -> dict:
        """realtime_x over the whole window (every input over the
        carriers' sample rate times the window's length, drain included)
        and the latencies of every packet given back, matched and dated
        after the window. Packets are due from the window's second input
        to `due_margin` inputs before its end: the program holds a
        readahead and its decoders' delay until a later input. Those that
        an input of the set-up completed are checked but not timed: they
        were handed over before the window."""
        import numpy as np
        span = self.t_end - self.t0
        self.settled = self.ledger.settle(
            np.asarray(self.handover), self.step,
            (self.window_first + 1) * self.step,
            (self.unit - self.cfg["due_margin"]) * self.step)
        timed = self.settled["chunk"] >= self.window_first
        lat = self.settled["latency"][timed] * 1e3
        self.latency_ms = lat

        def pct(q):
            return float(np.percentile(lat, q)) if len(lat) else float("inf")

        return dict(
            realtime_x=self.window_inputs * self.step / (self.fs * span),
            latency_p95_ms=pct(95), latency_p50_ms=pct(50),
            packets=int(len(lat)),
            step_ms_quarters=_quarters(np.diff(
                self.handover[self.window_first:])),
            lateness_ms=_quarters(self.lateness), **self._extras())

    def counts(self) -> tuple:
        """(packets due in the window, those bad, lost or never given
        back)."""
        s = self.settled
        failed = s["bad"] + s["lost"] + s["undelivered"]
        return len(s["t"]) + failed, failed

    def per_layer_data(self) -> dict:
        data = dict(spans=self.spans.per_unit(range(self.window_first,
                                                    self.unit)),
                    latency_ms=self.latency_ms,
                    kernel_shapes=self.kernel_shapes, trace=None)
        if self.profile is not None:
            data["trace"] = self.profile.reduce()
        return data


def _quarters(values) -> list:
    """The median (in ms) of each quarter of a window's values (seconds):
    a window that warms up, or a backlog that grows, reads differently
    from quarter to quarter."""
    import numpy as np
    v = np.asarray(values, dtype=float)
    if len(v) < 4:
        return []
    return [float(np.median(q)) * 1e3 for q in np.array_split(v, 4)]


# ------------------------------------------------------------------ result

def result_line(correct, attempted, failed, metrics, device, checks,
                breakdown=None) -> str:
    """The run's last line: the driver's keys, then the numbers compared
    with their limits under `checks`, last."""
    out = dict(correct=bool(correct), attempted=int(attempted),
               failed=int(failed), metrics=metrics, device=device)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
