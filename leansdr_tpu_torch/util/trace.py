"""Spans and counters inside the receivers: one registry.

Counters are always on: `count(name, n)` is an integer add
(`launch.<kernel>` for every kernel launch, the fleet's chunks, decodes,
bytes and lock events, the single carrier's reads). `counters()` reads
them all. A count that lives on the device (the segmented demod's
handover tallies) is handed over with `defer(names, values)`: inside a
`deferred()` collection it waits there until the caller's own copy of
its results to the host, after which `settle()` adds it, so that no
device work is waited for where the work is enqueued.

Spans time the layers of one input (a fleet chunk, a single-carrier
read) where the work happens:

    with trace.span("fleet.decode"):
        ...

Tracing is on while the receiver's entry thread records a torch
profiler, and after `enable()`. A receiver takes that decision once per
call on its entry thread (`begin(seq)`, with the sequence number of its
input) and hands the returned `Input` to the jobs the call queues on
other threads (`with inp:`), so an input traced on entry is traced
through to its back end: the profiler records one thread's operations
only, so a worker thread cannot ask it. A span outside any input is
recorded while a stretch of tracing is open and its own thread records
a profiler (or `enable()` holds).

Each span keeps its name, start and end in `time.perf_counter_ns()`, its
thread, its parent (a stack per thread) and its input's sequence number.
Where its thread records a torch profiler, a span is also an operation
of that name on the profiler's timeline, to which the profiler links the
kernels launched inside it (through torch or ctypes).
`Record.offset_ns` takes a span's times onto the profiler's host clock
(the epoch in ns), so that spans of any thread can be laid on a device
trace. When tracing is off, `span()` returns a shared no-op after one
flag test.

Spans go to a buffer of `CAPACITY` per stretch of tracing; what does
not fit is counted (`Record.dropped`). `record()` returns the last
stretch's spans and how much each counter rose over it;
`write_chrome()` writes a record as Chrome-trace JSON.
"""

import contextlib
import itertools
import json
import os
import sys
import threading
import time
from collections import namedtuple

CAPACITY = 1 << 17          # spans kept per stretch

Span = namedtuple("Span", "name start_ns end_ns thread id parent seq")

_perf_ns = time.perf_counter_ns


def _profiling() -> bool:
    """Whether this thread records a torch profiler (none can before torch
    is imported: this module does not import it, so that the host apps
    that read IQ stay free of it)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch._C._autograd._profiler_enabled()


_counters = {}
_enabled = False            # enable() holds
_open = None                # the open stretch
_last = None                # the last stretch opened
_ids = itertools.count(1)
_names = {}                 # thread ident -> thread name
_lock = threading.Lock()
_count_lock = threading.Lock()


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name` (always on; the receivers' threads count
    concurrently)."""
    with _count_lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> dict:
    """Every counter's value now."""
    return dict(_counters)


def defer(names: tuple, values) -> None:
    """Add `values` (a 1-D tensor, or a sequence of ints) to the counters
    `names`, in order: held by this thread's innermost open `deferred()`
    collection, a device tensor as its copy to the host, enqueued behind
    the work that computes it (`to("cpu", non_blocking=True)`: pinned,
    nothing waits); outside one, added at once (a device tensor's copy
    waits for its work)."""
    pend = _tls.deferred
    if pend:
        if hasattr(values, "to"):
            values = values.to("cpu", non_blocking=True)
        pend[-1].append((names, values))
    else:
        settle([(names, values)])


@contextlib.contextmanager
def deferred():
    """Collect this thread's defer() calls: yields the list of (names,
    values) pairs, which `settle()` adds later, on any thread, once a
    copy to the host enqueued after them on their stream has returned
    (the caller's own copy of its results)."""
    pend = []
    _tls.deferred.append(pend)
    try:
        yield pend
    finally:
        _tls.deferred.pop()


def settle(pending) -> None:
    """Add each (names, values) pair of a deferred() collection to its
    counters (the values' copy to the host waits for their work)."""
    for names, values in pending:
        if hasattr(values, "tolist"):
            values = values.tolist()
        for name, v in zip(names, values):
            count(name, int(v))


class _Local(threading.local):
    on = None               # the input's decision; None outside any input
    seq = -1

    def __init__(self):
        self.stack = []     # open span ids
        self.deferred = []  # open deferred() collections
        self.saved = []     # (on, seq) of the inputs entered around this one


_tls = _Local()


class Input:
    """The tracing decision and sequence number of one input. Entered
    (`with inp:`) on each thread that works on the input."""

    __slots__ = ("on", "seq")

    def __init__(self, on: bool, seq: int):
        self.on, self.seq = on, seq

    def __enter__(self):
        tl = _tls
        tl.saved.append((tl.on, tl.seq))
        tl.on, tl.seq = self.on, self.seq
        return self

    def __exit__(self, *exc):
        tl = _tls
        tl.on, tl.seq = tl.saved.pop()
        return False


def begin(seq: int) -> Input:
    """The entry's decision for input `seq`: on while this thread records
    a torch profiler or after enable(). Opens a stretch of tracing when
    tracing turns on, closes it when an entry finds it off."""
    on = _enabled or _profiling()
    if on:
        if _open is None:
            _start()
        return Input(True, seq)
    if _open is not None and not _enabled:
        _stop()
    return Input(False, seq)


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoSpan()


class _Span:
    __slots__ = ("name", "rf", "id", "parent", "t0", "tl")

    def __init__(self, name, tl):
        self.name, self.tl = name, tl

    def __enter__(self):
        tl = self.tl
        stack = tl.stack
        self.parent = stack[-1] if stack else 0
        self.id = next(_ids)
        stack.append(self.id)
        self.rf = None
        if _profiling():
            # FUNCTION scope (record_function's is USER scope): the
            # profiler links a kernel to the innermost such operation
            # around its launch, ctypes launches included, and to no
            # USER-scope one.
            self.rf = sys.modules["torch"]._C._profiler._RecordFunctionFast(
                self.name)
            self.rf.__enter__()
        self.t0 = _perf_ns()
        return self

    def __exit__(self, *exc):
        t1 = _perf_ns()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        self.tl.stack.pop()
        _add(self.name, self.t0, t1, self.id, self.parent, self.tl.seq)
        return False


def _traced(tl) -> bool:
    on = tl.on
    if on is None:          # outside any input
        return _open is not None and (_enabled or _profiling())
    return on


def span(name: str):
    """A context manager timing `name` when this thread traces, else a
    shared no-op."""
    if _last is None:
        return _NOOP
    tl = _tls
    if not _traced(tl):
        return _NOOP
    return _Span(name, tl)


def stamp() -> int:
    """`perf_counter_ns()` when this thread traces, else 0: the start of
    a span that `since()` ends later, on another thread."""
    return _perf_ns() if _last is not None and _traced(_tls) else 0


def since(name: str, t0: int) -> None:
    """Record span `name` from `t0` (a stamp(); nothing when 0) to now on
    this thread, under its open span."""
    if t0:
        tl = _tls
        _add(name, t0, _perf_ns(), next(_ids),
             tl.stack[-1] if tl.stack else 0, tl.seq)


def _add(name, t0, t1, sid, parent, seq):
    st = _last
    if st is None:
        return
    tid = threading.get_ident()
    if tid not in _names:
        _names[tid] = threading.current_thread().name
    if len(st.spans) < CAPACITY:
        st.spans.append(Span(name, t0, t1, tid, sid, parent, seq))
    else:
        with _count_lock:
            st.dropped += 1


def _clock_offset() -> int:
    """time.time_ns() - time.perf_counter_ns(), from the tightest of a
    few paired reads: the profiler's host clock is the epoch."""
    best = None
    for _ in range(16):
        a = _perf_ns()
        w = time.time_ns()
        b = _perf_ns()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return best[1]


class _Stretch:
    def __init__(self):
        self.spans = []
        self.dropped = 0
        self.offset_ns = _clock_offset()
        self.before = dict(_counters)
        self.after = None
        self.t_open = _perf_ns()
        self.t_close = None


def _start():
    global _open, _last
    with _lock:
        if _open is None:
            _open = _last = _Stretch()


def _stop():
    global _open
    with _lock:
        if _open is not None:
            _open.after = dict(_counters)
            _open.t_close = _perf_ns()
            _open = None


def enable() -> None:
    """Trace every input from now on, in one stretch until disable()."""
    global _enabled
    _enabled = True
    _start()


def disable() -> None:
    """Stop what enable() started and close its stretch."""
    global _enabled
    _enabled = False
    _stop()


def reset() -> None:
    """Drop every stretch and zero every counter."""
    global _last
    disable()
    with _lock:
        _last = None
        _counters.clear()


class Record:
    """One stretch of tracing: its spans (Span tuples, in the order they
    ended), how much each counter rose over it, the spans the buffer
    dropped, the offset from perf_counter_ns to the profiler's host
    clock, the threads' names and the stretch's bounds (perf_counter_ns;
    `stop_ns` None while it is open)."""

    def __init__(self, st: _Stretch):
        after = st.after if st.after is not None else dict(_counters)
        self.spans = list(st.spans)
        self.counters = {k: v - st.before.get(k, 0) for k, v in after.items()
                         if v != st.before.get(k, 0)}
        self.dropped = st.dropped
        self.offset_ns = st.offset_ns
        self.threads = dict(_names)
        self.start_ns, self.stop_ns = st.t_open, st.t_close

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def self_ns(self) -> dict:
        """{span id: its duration less its children's}."""
        own = {s.id: s.end_ns - s.start_ns for s in self.spans}
        for s in self.spans:
            if s.parent in own:
                own[s.parent] -= s.end_ns - s.start_ns
        return own


def record():
    """The last stretch of tracing (open or closed) as a Record, or None
    when none was opened."""
    st = _last
    return None if st is None else Record(st)


# libkineto's chrome export gives times in us after a base: the epoch
# second floored to a multiple of 7889238 s (ChromeTraceBaseTime).
_KINETO_BASE_S = 7889238


def chrome_events(rec: Record) -> dict:
    """A record as Chrome-trace JSON: spans as "X" events and each
    counter's rise over the stretch as "C" events, on the profiler's
    clock (the same base as a torch.profiler export, so the two
    overlay)."""
    pid = os.getpid()
    t_end = rec.stop_ns if rec.stop_ns is not None else _perf_ns()
    first = (rec.start_ns + rec.offset_ns) // 1_000_000_000
    base = first // _KINETO_BASE_S * _KINETO_BASE_S * 1_000_000_000

    def us(t):
        return (t + rec.offset_ns - base) / 1e3

    ev = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
           "args": {"name": name}} for tid, name in rec.threads.items()]
    ev += [{"name": s.name, "ph": "X", "ts": us(s.start_ns),
            "dur": (s.end_ns - s.start_ns) / 1e3, "pid": pid,
            "tid": s.thread, "args": {"seq": s.seq, "id": s.id,
                                      "parent": s.parent}}
           for s in rec.spans]
    for name, v in sorted(rec.counters.items()):
        ev += [{"name": name, "ph": "C", "ts": us(t), "pid": pid,
                "args": {"value": x}}
               for t, x in ((rec.start_ns, 0), (t_end, v))]
    return {"traceEvents": ev, "displayTimeUnit": "ms",
            "baseTimeNanoseconds": base,
            "otherData": {"dropped_spans": rec.dropped}}


def write_chrome(path: str, rec: Record = None) -> None:
    """Write `rec` (default: record()) to `path` as Chrome-trace JSON."""
    rec = record() if rec is None else rec
    with open(path, "w") as f:
        json.dump(chrome_events(rec) if rec is not None
                  else {"traceEvents": []}, f)
