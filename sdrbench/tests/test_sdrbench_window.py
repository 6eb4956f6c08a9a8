"""The end-to-end numbers are taken over the whole window and every
packet: realtime_x is all the work over all the time, and the tail is the
95th percentile of all packets' latencies, not of chunk medians."""

import numpy as np

from sdrbench import check, stimulus


def _ledger(npkt=16):
    cap = stimulus.Capture(iq=None, period=npkt * 100, npkt=npkt,
                           packets=stimulus.ts_packets(1, npkt),
                           stream=None,
                           end_sample=np.arange(npkt) * 100 + 99)
    return cap, check.PacketLedger(cap, 1)


def test_tail_is_over_all_packets():
    """Chunks of 100 samples, one packet each; chunk j handed over at j
    seconds. Twenty packets come back 0.1 s after their hand-over, the
    next nine together 5 s after the last of them: p95 over all packets
    sees the stall, a median of chunk medians would not."""
    cap, led = _ledger(32)
    sent = cap.packets[0]
    handovers = np.arange(40, dtype=float)
    for j in range(20):
        led.add(j + 0.1, [sent[j:j + 1]])
    led.add(28 + 5.0, [sent[20:29]])
    s = led.settle(handovers, 100, 100, 2900)
    lat = s["latency"]
    assert len(lat) == 29 and s["bad"] == 0 and s["lost"] == 0
    p95 = np.percentile(lat, 95)
    per_chunk = [np.median(lat[s["chunk"] == j]) for j in np.unique(s["chunk"])]
    assert p95 > 4.0 > np.median(per_chunk)


def test_lost_bad_and_undelivered_are_counted():
    cap, led = _ledger(16)
    sent = cap.packets[0]
    bad = sent[5].copy()
    bad[100] ^= 1
    led.add(1.0, [np.stack([sent[1], sent[2], sent[4], bad, sent[6]])])
    s = led.settle(np.arange(20, dtype=float), 100, 100, 1000)
    # 3 and 5 lost (5 came back altered: bad), and the packets due after
    # the last one given back (7, 8, 9, whose ends lie before 1000) never
    # came
    assert s["bad"] == 1
    assert s["lost"] == 2
    assert s["undelivered"] == 3


def test_realtime_x_is_one_rate_over_the_window():
    """The drivers' rate (harness.StreamDriver): inputs x samples per
    input over Fs x the window's whole length, drain included."""
    from sdrbench.harness import Cell, load_json
    from conftest import REPO
    bench = load_json(REPO / "BENCHMARK.json")
    cell = Cell(bench, "fleet12seq-tp36")
    drv = cell.driver_module().Driver(cell.config, cell.traffic, 1, "cpu")
    cap, led = _ledger(16)
    drv.cap, drv.ledger = cap, led
    drv.handover = [0.0, 0.5, 1.0, 3.0]
    drv.window_first, drv.unit = 0, 4
    drv.window_inputs = 4
    drv.t0, drv.t_end = 0.0, 4.0
    drv.track_at_window = True
    drv.modes = [True] * 4
    drv.lateness = [0.0] * 4
    led.add(3.5, [cap.packets[0][:2]])
    e = drv.end_to_end()
    assert np.isclose(e["realtime_x"], 4 * drv.chunk / (drv.fs * 4.0))


def test_end_to_end_names_resolve_to_the_runs_quantities():
    """Each end-to-end metric is the quantity its name gives after the
    last dot, which every cell's driver reports (setup_s is run.py's)."""
    from sdrbench.harness import load_json
    from conftest import REPO
    bench = load_json(REPO / "BENCHMARK.json")
    given = {"realtime_x", "latency_p95_ms", "setup_s"}
    for m in bench["end_to_end"]:
        assert m["name"].rsplit(".", 1)[-1] in given, m["name"]


class _Ev:
    """A stand-in for the profiler's FunctionEvent: its own kernels as
    (name, us) pairs."""

    def __init__(self, name, cuda=False, start=0, end=0, kernels=(),
                 children=()):
        from types import SimpleNamespace
        from torch.autograd import DeviceType
        self.name = name
        self.device_type = DeviceType.CUDA if cuda else DeviceType.CPU
        self.time_range = SimpleNamespace(start=start, end=end)
        self.kernels = [SimpleNamespace(name=n, duration=us)
                        for n, us in kernels]
        self.cpu_children = list(children)


def test_scopes_take_the_operations_outside_the_scopes_inside():
    """A scope holds the device operations the profiler links to the host
    operations under it, less those under the scopes inside it; its
    device-side annotation is no device operation and does not make the
    card busy."""
    from types import SimpleNamespace
    from sdrbench.harness import reduce_trace
    inner = _Ev("sdrbench.demod", children=[
        _Ev("aten::copy_", kernels=[("copy_kernel", 3000.0)])])
    op = _Ev("aten::add", kernels=[("add_kernel", 500.0)],
             children=[_Ev("aten::mul", kernels=[("mul_kernel", 250.0)])])
    outer = _Ev("sdrbench.segmented", start=0, end=100,
                children=[op, inner])
    events = [outer, op, inner,
              _Ev("sdrbench.segmented", cuda=True, start=0, end=9000),
              _Ev("demod_kernel", cuda=True, start=100, end=3100),
              _Ev("add_kernel", cuda=True, start=5000, end=5500)]
    tr = reduce_trace(SimpleNamespace(events=lambda: events), 1.0)
    assert tr["scopes"]["segmented"] == {"add_kernel": 500e-6,
                                         "mul_kernel": 250e-6}
    assert tr["scopes"]["demod"] == {"copy_kernel": 3000e-6}
    assert set(tr["ops"]) == {"demod_kernel", "add_kernel"}
    assert abs(tr["busy_s"] - 3.5e-3) < 1e-12
    from sdrbench.metrics._common import scope_ms_per_input
    tr["units"] = (10, 12)
    data = {"trace": tr}
    assert abs(scope_ms_per_input(data, "segmented") - 0.375) < 1e-9
    assert abs(scope_ms_per_input(data, "segmented", exclude="mul")
               - 0.25) < 1e-9
    assert scope_ms_per_input(data, "decode") is None
