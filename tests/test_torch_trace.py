"""The port's tracing layer (leansdr_tpu_torch/util/trace.py) on the CPU:
the off path, nested spans and self time, the buffer's bound, the span
tree of a fleet submit() (worker threads included) and of a
single-carrier process(), spans as torch.profiler operations on the
profiler's clock, the per-layer metric readers that read the record
(sdrbench/metrics/), and `--trace FILE` of leandvb and leandvbfleet.

The fleet's tree runs at the fleet tests' shape (2 carriers, chunks of
4096) and the single carrier's on one block of the notch (4096 samples),
each with a stand-in for the demod (a symbol every other sample), so
that the fleet's decodes come within four chunks in well under a second;
the plain demod takes ~1 ms a sample here.
"""

import io
import json
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from leansdr_tpu_torch.util import trace

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def fresh():
    trace.reset()
    yield
    trace.reset()


def test_off_records_nothing_and_counters_count():
    inp = trace.begin(0)
    assert not inp.on
    with inp, trace.span("a"):
        with trace.span("b"):
            pass
    assert trace.span("a") is trace.span("b")        # the shared no-op
    assert trace.stamp() == 0
    trace.count("x")
    trace.count("x", 4)
    assert trace.counters()["x"] == 5
    assert trace.record() is None


def test_nested_spans_carry_parents_and_self_time():
    trace.enable()
    with trace.begin(7):
        with trace.span("outer"):
            time.sleep(0.002)
            with trace.span("inner"):
                time.sleep(0.001)
            with trace.span("inner"):
                pass
        trace.count("c", 3)
    trace.disable()
    with trace.span("after"):                       # tracing is off
        pass
    rec = trace.record()
    (outer,), inner = rec.named("outer"), rec.named("inner")
    assert [s.name for s in rec.spans] == ["inner", "inner", "outer"]
    assert outer.parent == 0 and outer.seq == 7
    assert all(s.parent == outer.id and s.seq == 7 for s in inner)
    assert all(s.thread == threading.get_ident() for s in rec.spans)
    own = rec.self_ns()
    dur = outer.end_ns - outer.start_ns
    assert own[outer.id] == dur - sum(s.end_ns - s.start_ns for s in inner)
    assert own[outer.id] >= 2_000_000
    assert own[inner[0].id] == inner[0].end_ns - inner[0].start_ns
    assert rec.counters == {"c": 3} and rec.dropped == 0
    assert rec.stop_ns is not None


def test_counters_lose_no_update_across_threads():
    import sys
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [trace.count("n")
                                               for _ in range(2000)])
              for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(switch)
    assert trace.counters()["n"] == 8 * 2000


def test_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 5)
    trace.enable()
    with trace.begin(0):
        for _ in range(8):
            with trace.span("s"):
                pass
    rec = trace.record()
    assert len(rec.spans) == 5 and rec.dropped == 3


def _stand_in_demod(params, sym_consts, tables, st, x):
    """The demod's contract (state, sym, valid, cost) at no cost: a
    symbol every other sample."""
    n = x.shape[1] - params.readahead
    C = x.shape[0]
    g = torch.Generator().manual_seed(n)
    sym = torch.randint(0, 4, (n, C), generator=g).to(torch.uint8)
    valid = (torch.arange(n) % 2 == 0)[:, None].expand(n, C).contiguous()
    return st, sym, valid, torch.zeros((n, C), dtype=torch.int16)


FLEET_TREE = {"fleet.dispatch": "fleet.submit", "fleet.ingest":
              "fleet.dispatch", "fleet.plan": "fleet.dispatch",
              "fleet.demod": "fleet.dispatch", "fleet.ring_append":
              "fleet.dispatch", "fleet.pack": "fleet.dispatch",
              "fleet.fetch_wait": "fleet.collect", "fleet.unpack":
              "fleet.collect", "fleet.backend_feed": "fleet.collect"}


# Spans of the fetch and back-end threads.
WORKER = ("fleet.fetch", "fleet.backend_queue", "fleet.collect",
          "fleet.fetch_wait", "fleet.unpack", "fleet.backend_feed")


def test_fleet_submit_span_tree(monkeypatch):
    from leansdr_tpu_torch.dsp.cstln import Predef
    from leansdr_tpu_torch.pipelines import multi_rx
    from leansdr_tpu_torch.pipelines.dvbs_rx import RxConfig
    monkeypatch.setattr(multi_rx, "demod", _stand_in_demod)
    C, chunk = 2, 4096
    cfg = RxConfig(Fs=4e6, Fm=2e6, rate="1/2", constellation=Predef.QPSK,
                   sampler="linear", fastlock=True, viterbi=False,
                   exact_lut=False, float_scale=1.0)
    rx = multi_rx.MultiDvbsReceiver(cfg, C, chunk_samples=chunk,
                                    device="cpu")
    rx.max_inflight = 1
    ra = rx.readahead
    x = np.random.default_rng(1).standard_normal(
        (C, 4 * chunk + ra, 2)).astype(np.float32)
    trace.enable()
    before = trace.counters()
    for k in range(4):
        rx.submit(x[:, :chunk + ra] if k == 0
                  else x[:, k * chunk + ra:(k + 1) * chunk + ra])
    rx.flush()
    rx.close()
    trace.disable()
    rec = trace.record()
    main = threading.get_ident()
    by_id = {s.id: s for s in rec.spans}
    for seq in range(4):
        mine = [s for s in rec.spans if s.seq == seq]
        names = {s.name for s in mine}
        assert names >= set(FLEET_TREE) | {
            "fleet.submit", "fleet.fetch", "fleet.collect",
            "fleet.backend_queue"}, (seq, names)
        for s in mine:
            if s.name in FLEET_TREE:
                assert by_id[s.parent].name == FLEET_TREE[s.name], s
            if s.name in WORKER:
                assert s.thread != main, s
            elif s.name.startswith("fleet."):
                assert s.thread == main, s
        (fetch,), (collect,) = ([s for s in mine if s.name == n]
                                for n in ("fleet.fetch", "fleet.collect"))
        assert fetch.parent == 0 and collect.parent == 0
        assert fetch.thread != collect.thread
    decodes = rec.named("fleet.decode")
    assert decodes and all(by_id[s.parent].name == "fleet.dispatch"
                           for s in decodes)
    assert all(by_id[s.parent].name == "fleet.submit"
               for s in rec.named("fleet.wait"))
    assert rec.named("fleet.wait")
    c = {k: v - before.get(k, 0) for k, v in trace.counters().items()}
    assert c["fleet.submits"] == 4 and c["fleet.chunks"] == 4
    assert c["fleet.decodes.acquire"] == len(decodes)
    assert "fleet.decodes.track" not in c
    assert c["fleet.h2d_bytes"] == C * (4 * chunk + 4 * ra) * 8
    assert c["fleet.d2h_bytes"] > 0
    assert c["fleet.inflight"] >= 4


def test_single_carrier_process_spans(monkeypatch):
    from leansdr_tpu_torch.dsp import receiver_kernel as rk
    from leansdr_tpu_torch.dsp.cstln import Predef
    from leansdr_tpu_torch.pipelines.dvbs_rx import DvbsReceiver, RxConfig
    from leansdr_tpu_torch.util.iofmt import read_iq

    def stand_in(params, sym_consts, planes, x):
        n = x.shape[1] - 1
        valid = (torch.arange(n, dtype=torch.int32) % 2) << 24
        return planes, valid[:, None].expand(n, x.shape[0]).contiguous()

    monkeypatch.setattr(rk, "demod", stand_in)
    rx = DvbsReceiver(RxConfig(Fs=2.4e6, Fm=2e6, rate="1/2",
                               constellation=Predef.QPSK, sampler="rrc",
                               anf=1, exact_lut=False, float_scale=1.0),
                      device="cpu")
    # The notch gives out whole blocks of 4096 samples.
    n = 4096
    raw = np.random.default_rng(2).integers(
        100, 156, 2 * n).astype(np.uint8).tobytes()
    trace.enable()
    rx.process(read_iq(raw, "u8"))
    trace.disable()
    rec = trace.record()
    (top,) = rec.named("rx.process")
    (read,) = rec.named("io.read_iq")
    assert read.seq == -1 and read.parent == 0 and top.seq == 0
    by_id = {s.id: s for s in rec.spans}
    kids = {s.name for s in rec.spans if s.parent == top.id}
    assert kids == {"rx.preprocess", "rx.ingest", "rx.mf", "rx.demod",
                    "rx.fetch", "rx.meas", "rx.deconv", "rx.bytes"}
    (notch,) = rec.named("rx.notch")
    assert by_id[notch.parent].name == "rx.preprocess"
    assert not [s for s in rec.spans if s.name.startswith("kernel.")]
    assert rec.counters["rx.reads"] == 1
    m = (n - rx.readahead) // 128 * 128
    assert rec.counters["rx.h2d_bytes"] == (m + rx.readahead) * 8
    assert rec.counters["rx.d2h_bytes"] == m * 4


def test_spans_are_profiler_operations_on_its_clock():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        inp = trace.begin(3)
        with inp, trace.span("t.outer"):
            with trace.span("t.inner"):
                torch.ones(8).add_(1)
            # A worker thread is traced through its input, off the
            # profiler's timeline.
            w = threading.Thread(target=lambda: [
                None for _ in [inp.__enter__(), trace.span(
                    "t.worker").__enter__().__exit__(), inp.__exit__()]])
            w.start()
            w.join()
    assert not trace.begin(4).on                # closes the stretch
    rec = trace.record()
    ops = {e.name(): e.start_ns()
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("t.")}
    assert set(ops) == {"t.outer", "t.inner"}
    for s in rec.spans:
        if s.name in ops:
            assert abs(s.start_ns + rec.offset_ns - ops[s.name]) < 50_000
    (worker,) = rec.named("t.worker")
    assert worker.seq == 3 and worker.thread != threading.get_ident()


def _span(name, ms, seq=0):
    return trace.Span(name, 0, int(ms * 1e6), 1, 0, 0, seq)


SYNTHETIC = types.SimpleNamespace(
    spans=[_span("fleet.dispatch", 90), _span("fleet.dispatch", 91),
           _span("fleet.wait", 3), _span("fleet.wait", 1),
           _span("fleet.decode", 10), _span("fleet.decode", 20),
           _span("fleet.fetch", 0.5), _span("fleet.backend_queue", 4),
           _span("fleet.backend_queue", 2)]
    + [_span("rx.process", 50)] * 4 + [_span("rx.preprocess", 2)] * 4
    + [_span("rx.fetch", 9)] * 4,
    counters={"fleet.decodes.track": 3, "fleet.decodes.acquire": 1})


@pytest.mark.parametrize("metric,want", [
    ("fleet.submit_wait_ms", 2.0), ("fleet.decode_enqueue_ms", 15.0),
    ("fleet.track_pct", 75.0), ("fleet.fetch_ms", 0.25),
    ("fleet.backend_wait_ms", 3.0), ("sc.preprocess_ms", 2.0),
    ("sc.fetch_ms", 9.0)])
def test_metric_reader(metric, want, monkeypatch):
    from sdrbench.harness import load_module
    mod = load_module(REPO / "sdrbench" / "metrics" / f"{metric}.py",
                      "trace_reader_" + metric.replace(".", "_"))
    monkeypatch.setattr(mod, "record", lambda: SYNTHETIC)
    assert mod.read({}) == pytest.approx(want)
    monkeypatch.setattr(mod, "record", lambda: None)   # no tracing layer
    assert mod.read({}) is None


@pytest.mark.parametrize("app", ["leandvb", "leandvbfleet"])
def test_cli_trace_file(app, tmp_path, monkeypatch):
    import importlib
    mod = importlib.import_module(f"leansdr_tpu_torch.apps.{app}")
    raw = np.random.default_rng(3).integers(
        100, 156, 2 * 640).astype(np.uint8).tobytes()
    monkeypatch.setattr("sys.stdin", io.TextIOWrapper(io.BytesIO(raw)))
    monkeypatch.setattr("sys.stdout", io.TextIOWrapper(io.BytesIO()))
    out = tmp_path / "trace.json"
    args = ["--u8", "-f", "2.4e6", "--sr", "2e6", "--cr", "1/2",
            "--device", "cpu", "--trace", str(out)]
    if app == "leandvbfleet":
        args += ["--nchan", "1", "--chunk", "640"]
    assert mod.main(args) == 0
    doc = json.loads(out.read_text())
    ev = doc["traceEvents"]
    spans = {e["name"] for e in ev if e["ph"] == "X"}
    entry = "rx.process" if app == "leandvb" else "fleet.submit"
    assert entry in spans and "io.read_iq" in spans
    assert {e["name"] for e in ev if e["ph"] == "C"} >= {
        "rx.reads" if app == "leandvb" else "fleet.submits"}
    assert all(e["ts"] > 0 and e["dur"] >= 0 for e in ev if e["ph"] == "X")
    assert doc["baseTimeNanoseconds"] > 0
