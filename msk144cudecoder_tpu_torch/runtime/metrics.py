"""Wall-clock metrics, the real-time budget monitor, and the port's tracing.

Mirror of reference src/metrics.{h,cpp}: `SimpleTimer` is the always-on
elapsed-ms reader behind the 210 ms soft-budget warning (main.cu:398-403);
`ScopedMetric` is the nesting RAII span, enabled by the MSK144_TPU_METRICS
environment variable (the JAX package's switch, so one setting instruments
both) instead of a compile-time define.

The switch is read once per call into a public entry point (`refresh()`:
StreamDecoder's submit, collect, decode_block, decode_to_host and
postprocess_batch, and each CLI loop), not once per span: a span opened
while it is off costs one flag check, a counter add one call. While it is on,
every span and counter goes to the process's `Recorder` (`recorder()`),
which starts afresh each time the switch turns on and keeps:

- per span name, exact aggregates: count, total and self time (the span
  less its children on its thread), and the count and total of those that
  ran under a torch profiler; each thread adds to tallies of its own, with
  no lock, summed when read;
- the spans a reader pairs (`KEPT`: per batch, per capture) one by one, with
  their thread, parent and request id, the newest `KEPT_MAX`;
- the counters (`count()`), tallied per thread the same way;
- an anchor, one (perf_counter_ns, time_ns) pair taken at the start, which
  puts a span on the unix-ns timeline of a torch profiler's trace.

Spans nest per thread. `request(rid)` tags the spans its thread opens
inside it: the throughput CLI's batch number, decode_block's call number.
While a torch profiler records on the span's thread, or the CLI's
`--profile-dir` profiler (`trace_ranges()`, every thread) runs, a span also
opens a `record_function` range named `msk144.<name>`, so the trace carries
the program's spans. The eight spans the reference prints (`PRINTED`) also
print `Measured time: <name> <ms> ms` on standard error when they end,
indented two spaces per printed span open around them on their thread, as
the reference does; every other span, and every counter, stays in memory.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import sys
import threading
import time
from typing import Dict, List, NamedTuple, Optional

from torch._C._autograd import _profiler_enabled
from torch.autograd.profiler import record_function

ENV = "MSK144_TPU_METRICS"

#: the spans the reference prints, in the reference's format
PRINTED = frozenset(("working_loop", "ingest", "submit", "collect", "device_wait_transfer",
                     "postprocess", "unpack77", "result_filter"))
#: the spans a reader pairs, kept one by one
KEPT = frozenset(("frame_batch", "decode_to_host", "drain", "graph_capture"))
KEPT_MAX = 1 << 16


def metrics_enabled() -> bool:
    return os.environ.get(ENV, "0") not in ("0", "", "false")


class SimpleTimer:
    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()

    def milliseconds_elapsed(self) -> float:
        return (time.perf_counter() - self._t0) * 1000.0


class Aggregate:
    """One span name's totals over the recording, in ns."""

    __slots__ = ("count", "total_ns", "self_ns", "profiled_count", "profiled_ns")

    def __init__(self) -> None:
        self.count = self.total_ns = self.self_ns = 0
        self.profiled_count = self.profiled_ns = 0  # the spans under a profiler


class Span(NamedTuple):
    name: str
    sid: int  # this span's id in the process
    parent: Optional[int]  # the enclosing span's id on its thread
    thread: int  # threading.get_ident()
    rid: Optional[int]  # the request id its thread had when it opened
    start_ns: int  # time.perf_counter_ns()
    end_ns: int


class Recorder:
    """What the spans and counters recorded since the switch last turned on.
    Each thread adds to tallies of its own, without a lock; `aggregates` and
    `counters` sum them when read."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._gen = 0  # the recording's number
        self.start()

    def start(self) -> None:
        """Forget everything and take a new anchor."""
        with self._lock:
            self._gen += 1
            self._tallies: List[tuple] = []  # each thread's (aggregates, counters)
            self.kept: collections.deque = collections.deque(maxlen=KEPT_MAX)
            a = time.perf_counter_ns()
            u = time.time_ns()
            self.anchor = ((a + time.perf_counter_ns()) // 2, u)

    def _join(self, t: "_Thread") -> None:
        """Give thread t fresh tallies in this recording."""
        with self._lock:
            t.gen = self._gen
            t.aggregates = {}
            t.counters = {}
            self._tallies.append((t.aggregates, t.counters))

    @property
    def aggregates(self) -> Dict[str, Aggregate]:
        """Per span name, over every thread."""
        out: Dict[str, Aggregate] = {}
        for aggs, _ in list(self._tallies):
            for name, a in list(aggs.items()):
                m = out.get(name)
                if m is None:
                    m = out[name] = Aggregate()
                for k in Aggregate.__slots__:
                    setattr(m, k, getattr(m, k) + getattr(a, k))
        return out

    @property
    def counters(self) -> Dict[str, int]:
        """Per counter, over every thread."""
        out: Dict[str, int] = collections.defaultdict(int)
        for _, counts in list(self._tallies):
            for name, n in list(counts.items()):
                out[name] += n
        return out

    def unix_ns(self, perf_ns: int) -> int:
        """A perf_counter_ns() reading on the unix-ns clock of a profiler's trace."""
        return perf_ns - self.anchor[0] + self.anchor[1]

    def spans(self, name: str) -> List[Span]:
        """The kept spans of that name, in the order they ended."""
        return [s for s in list(self.kept) if s.name == name]


class _Thread(threading.local):
    def __init__(self) -> None:
        self.ident = threading.get_ident()
        self.stack: List[ScopedMetric] = []  # the recorded spans open on this thread
        self.printed = 0  # of them, the printed ones
        self.rid: Optional[int] = None
        self.gen = 0  # the recording its tallies belong to
        self.aggregates: Dict[str, Aggregate] = {}
        self.counters: Dict[str, int] = {}


_recorder = Recorder()
_thread = _Thread()
_ids = itertools.count(1)
_switch_lock = threading.Lock()
_on = False  # the switch, as the last public call read it: record
_ranges = False  # the CLI's profiler runs on every thread: open record_function ranges
_active = False  # _on or _ranges: a span does anything


def refresh() -> bool:
    """Read the switch; a new recording starts when it turns on. Public
    entry points call this once per call."""
    global _on, _active
    on = metrics_enabled()
    if on != _on:
        with _switch_lock:
            if on and not _on:
                _recorder.start()
            _on = on
            _active = _on or _ranges
    return on


def recorder() -> Recorder:
    return _recorder


def count(name: str, n: int) -> None:
    """Add n to a counter, while the switch is on."""
    if _on:
        t = _thread
        if t.gen != _recorder._gen:
            _recorder._join(t)
        c = t.counters
        c[name] = c.get(name, 0) + n


@contextlib.contextmanager
def trace_ranges():
    """Open a `msk144.<name>` record_function range for every span on every
    thread for the block (a profiler of every thread runs around it), whether
    the switch is on or not."""
    global _ranges, _active
    with _switch_lock:
        _ranges = True
        _active = True
    try:
        yield
    finally:
        with _switch_lock:
            _ranges = False
            _active = _on


class request:
    """Tags with rid the spans this thread opens inside it, while the switch
    is on."""

    __slots__ = ("_rid", "_prev", "_t")

    def __init__(self, rid: int) -> None:
        self._rid = rid
        self._t = None

    def __enter__(self) -> "request":
        if _on:
            t = self._t = _thread
            self._prev = t.rid
            t.rid = self._rid
        return self

    def __exit__(self, *exc) -> None:
        if self._t is not None:
            self._t.rid = self._prev


class ScopedMetric:
    """A span: recorded while the switch is on, a profiler range while one
    runs, and for the names in PRINTED `Measured time: <name> <ms>` on stop,
    indented by nesting level (metrics.cpp:35-46). Usable as a context
    manager or via explicit stop()."""

    __slots__ = ("_name", "_level", "_open", "_recorded", "_rf", "_t0", "_child_ns", "_sid",
                 "_parent", "_rid", "_thread")

    def __init__(self, name: str, level: Optional[int] = None) -> None:
        self._open = _active
        if not _active:
            return
        self._name = name
        self._recorded = _on
        if _on:
            t = self._thread = _thread
            self._parent = t.stack[-1] if t.stack else None
            self._rid = t.rid
            self._sid = next(_ids)
            self._child_ns = 0
            if name in PRINTED:
                self._level = t.printed if level is None else level
                t.printed += 1
            else:
                self._level = None
            t.stack.append(self)
        self._t0 = time.perf_counter_ns()
        if _ranges or _profiler_enabled():
            self._rf = record_function("msk144." + name)
            self._rf.__enter__()
        else:
            self._rf = None

    def stop(self) -> None:
        if not self._open:
            return
        self._open = False
        rf = self._rf
        if rf is not None:
            rf.__exit__(None, None, None)
        end = time.perf_counter_ns()
        if not self._recorded:
            return
        t = self._thread
        if t.stack and t.stack[-1] is self:
            t.stack.pop()
        else:
            t.stack.remove(self)
        name = self._name
        dur = end - self._t0
        parent = self._parent
        if parent is not None:
            parent._child_ns += dur
        rec = _recorder
        if t.gen != rec._gen:
            rec._join(t)
        agg = t.aggregates.get(name)
        if agg is None:
            agg = t.aggregates[name] = Aggregate()
        agg.count += 1
        agg.total_ns += dur
        agg.self_ns += dur - self._child_ns
        if rf is not None:
            agg.profiled_count += 1
            agg.profiled_ns += dur
        if name in KEPT:
            rec.kept.append(Span(name, self._sid, parent._sid if parent else None, t.ident,
                                 self._rid, self._t0, end))
        if self._level is not None:
            t.printed -= 1
            print(f"{'  ' * self._level}Measured time: {name} {dur / 1e6:.3f} ms", file=sys.stderr)

    def __enter__(self) -> "ScopedMetric":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
