"""The port's tracing: named host spans, and the counters beside them.

Spans. `span(name)` is a context manager around work on one thread.
`begin(name, rid)` and `end(token)` cover a span that begins on one thread
and ends on another: a request's wait in `BatchingServer`'s queue. Each
finished span is a `Span` record: its name, the thread it began on
(`threading.get_native_id()`, the id a profiler trace gives that thread),
its start and end in `time.perf_counter_ns()`, its parent (the id of the
span open on that thread when it began) and its request id. Records wait in
per-thread lists until `drain()` takes them all; nothing is written to a
file.

While tracing is on, a same-thread span also opens the profiler range
`renderih.<name>` (`torch.profiler.record_function`), so a profiler trace
ties the device's work to it, on the trace's own clock. `begin` marks its
start on the trace with a range of its name that closes at once: pairing
those marks, or any span's range, with the records gives the offset from
`perf_counter_ns` to the trace's clock (`clock_offset_us`), which places
the cross-thread spans, and the spans of threads the profiler does not
record, on the trace.

Tracing is off until `enable(True)`, and whoever turns it on drains the
records and turns it off again. Off, `span` is one check that returns a
shared null context and `begin` returns None: nothing is recorded and no
range opens, profiler or not.

Counters. `Counter` is a count that any thread may add to: the kernels'
launch counters (`kernels/_build.py` keeps it as `LaunchCounter`) and the
named counters of `counter(name)`: `engine.rows` and `engine.pad_rows`,
the real and the padded rows of every forward of `InferenceEngine.predict`;
`engine.graph_captures`, `engine.graph_replays` and `engine.eager_forwards`,
the engine's CUDA graphs (`serve.py`). Counters count whether tracing is on
or not. Inside `hold()` a thread's adds are held back and handed to the
block instead: a CUDA graph's capture runs its calls' Python but none of
their work, and its replays add what the capture held.
"""

from __future__ import annotations

import contextlib
import itertools
import statistics
import threading
import time
from typing import NamedTuple

import torch.autograd.profiler as _profiler

PREFIX = "renderih."

_on = False
_NULL = contextlib.nullcontext()
_ids = itertools.count()
_local = threading.local()
_lists: list = []  # every thread's list of finished records
_lock = threading.Lock()


class Span(NamedTuple):
    name: str
    tid: int       # native id of the thread the span began on
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    parent: int    # id of the span open on that thread when it began; -1 if none
    rid: int       # request id of a `begin` span (a wait); -1 for a same-thread span
    id: int


def enable(on: bool) -> None:
    """Turn tracing on or off."""
    global _on
    _on = on


def _thread() -> tuple:
    """This thread's (native id, ids of its open spans, its finished records)."""
    state = getattr(_local, "state", None)
    if state is None:
        state = _local.state = (threading.get_native_id(), [], [])
        with _lock:
            _lists.append(state[2])
    return state


class _Span:
    __slots__ = ("name", "range", "state", "parent", "id", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = _profiler.record_function(PREFIX + self.name)
        self.range.__enter__()
        self.state = _, stack, _ = _thread()
        self.parent = stack[-1] if stack else -1
        self.id = next(_ids)
        stack.append(self.id)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        tid, stack, done = self.state
        stack.pop()
        done.append(Span(self.name, tid, self.start, end, self.parent, -1, self.id))
        self.range.__exit__(*exc)
        return False


def span(name: str):
    """A span around the `with` block on this thread; a shared null context
    while tracing is off."""
    if not _on:
        return _NULL
    return _Span(name)


def begin(name: str, rid: int):
    """Start the span of request `rid`'s wait, which another thread may `end`;
    None while tracing is off."""
    if not _on:
        return None
    tid, stack, _ = _thread()
    mark = _profiler.record_function(PREFIX + name)
    mark.__enter__()
    start = time.perf_counter_ns()  # stamped as a same-thread span's start is
    mark.__exit__(None, None, None)
    return (name, tid, start, stack[-1] if stack else -1, rid, next(_ids))


def end(token) -> None:
    """End the span `begin` returned, on whichever thread this runs."""
    if token is None:
        return
    end_ns = time.perf_counter_ns()
    name, tid, start, parent, rid, id_ = token
    _thread()[2].append(Span(name, tid, start, end_ns, parent, rid, id_))


def drain() -> list:
    """Every finished span of every thread, by start, and forget them."""
    out = []
    with _lock:
        for done in _lists:
            n = len(done)
            out.extend(done[:n])
            del done[:n]
    return sorted(out, key=lambda s: s.start_ns)


def clock_offset_us(ranges: list, spans: list) -> float | None:
    """Microseconds to add to `start_ns / 1e3` to land on a profiler trace's
    clock. `ranges` are the trace's `renderih.*` ranges as (thread id, name
    without the prefix, start in µs); `spans` the records of the same run.
    For each (thread, name) whose ranges and records are as many, the i-th
    range pairs with the i-th record; the median of the pairs' differences.
    None where no group pairs."""
    def groups(items, key, at):
        out: dict = {}
        for it in items:
            out.setdefault(key(it), []).append(at(it))
        return out

    traced = groups(ranges, lambda r: (r[0], r[1]), lambda r: r[2])
    held = groups(spans, lambda s: (s.tid, s.name), lambda s: s.start_ns / 1e3)
    diffs = [t - h for key, ts in traced.items() if len(held.get(key, ())) == len(ts)
             for t, h in zip(sorted(ts), sorted(held[key]))]
    return statistics.median(diffs) if diffs else None


class Counter:
    """A count that any thread may add to."""

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        held = getattr(_local, "held", None)
        if held is not None:
            held.append((self, n))
            return
        with self._lock:
            self._n += n

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        return self._n


@contextlib.contextmanager
def hold():
    """Hold back every count this thread adds inside the block: the list it
    yields gets each as (counter, n), and no counter changes."""
    _local.held = held = []
    try:
        yield held
    finally:
        _local.held = None


_counters: dict = {}


def counter(name: str) -> Counter:
    """The process's counter called `name`, made at first use."""
    with _lock:
        return _counters.setdefault(name, Counter())


def counters() -> dict:
    """{name: value} of every named counter."""
    with _lock:
        return {name: c.value for name, c in _counters.items()}
