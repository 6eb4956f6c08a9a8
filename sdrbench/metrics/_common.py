"""Helpers the per-layer metric readers share (not a metric)."""

import numpy as np


def mean(values):
    values = list(values or ())
    return sum(values) / len(values) if values else None


def kernel_seconds(trace, key: str):
    """Device seconds of the operations whose name holds `key` in the
    traced stretch, or None where there are none."""
    if not trace:
        return None
    s = sum(v for n, v in trace["ops"].items() if key in n)
    return s if s > 0 else None


def scope_ms_per_input(data, scope: str, exclude: str = None):
    """Device ms per input of the operations launched under the
    benchmark's profiler scope `scope` (and outside the scopes inside it)
    in the traced stretch, less those whose name holds `exclude`; None
    where the profiler saw none."""
    tr = data.get("trace")
    if not tr:
        return None
    ops = tr["scopes"].get(scope, {})
    s = sum(v for n, v in ops.items() if not exclude or exclude not in n)
    if s <= 0:
        return None
    lo, hi = tr["units"]
    return 1e3 * s / max(hi - lo, 1)


def traced_shapes(data, kernel: str) -> list:
    """The launch shapes of `kernel` recorded in the traced stretch."""
    tr = data.get("trace")
    if not tr:
        return []
    lo, hi = tr["units"]
    return [s[1:] for s in data["kernel_shapes"].get(kernel, ())
            if lo <= s[0] < hi]


def idle_pct(data):
    """The share of the traced stretch in which no operation ran on the
    card, in %."""
    tr = data.get("trace")
    if not tr or not tr["traced"] or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def latency_ms(data, q: float):
    """The q-th percentile of the latencies of the packets the end-to-end
    tail is taken over."""
    lat = data.get("latency_ms")
    if lat is None or not len(lat):
        return None
    return float(np.percentile(lat, q))
