"""The program's own record of the traced window, for the readers of its
spans and counters.

With MSK144_TPU_METRICS on (the traced run's window, and only it), the
port's `runtime.metrics` keeps in memory its spans' aggregates by name, the
spans a reader pairs (with thread, parent and request id), its counters and
an anchor onto the profiler's clock. `recorder()` returns that record, or
None where the port keeps none (a port older than its in-memory recorder),
and the readers then return None. `untraced_idle` reads the device trace
against the program's `msk144.<span>` ranges in it, but for the spans that
wrap a whole request.
"""

from __future__ import annotations

import bisect
from typing import Optional

from . import trace

PREFIX = "msk144."
#: the spans that wrap a whole request (a batch's drain, a worker's pass):
#: their time is their children's and whatever runs around them, the
#: harness's hooks included, so they name no activity of their own
ROOTS = frozenset(PREFIX + n for n in ("drain", "decode_to_host"))


def recorder():
    """The port's Recorder, or None where the port has none."""
    try:
        from msk144cudecoder_tpu_torch.runtime import metrics
    except ImportError:
        return None
    get = getattr(metrics, "recorder", None)
    return get() if callable(get) else None


def aggregate(name: str):
    """The recorder's aggregate of span `name` (count, total_ns, self_ns,
    profiled_count, profiled_ns), or None."""
    rec = recorder()
    return None if rec is None else rec.aggregates.get(name)


def note(run, key: str, value) -> None:
    """A reading beside a metric, in the result line's info (under
    info.check, the one part of it a reader can reach)."""
    run.check.setdefault("info", {})[key] = value


def ranges(s: trace.Slice):
    """The union of the program's ranges in the slice that name an activity:
    every `msk144.*` range but the request roots (ROOTS)."""
    return trace.union([(o.start_ns, o.start_ns + o.dur_ns) for o in s.host
                        if o.name.startswith(PREFIX) and o.name not in ROOTS])


def untraced_idle(s: trace.Slice) -> Optional[float]:
    """Of the device's idle time between its first and last op in the slice
    (the gaps `Slice.idle_gaps` splits), the share in percent whose gap
    midpoint falls under none of the program's activity ranges (`ranges`).
    None without device ops or program ranges in the slice."""
    if s is None or not s.done or not s.device:
        return None
    covered = ranges(s)
    if not covered:
        return None
    starts = [a for a, _ in covered]
    busy = s.busy_intervals()
    total = left = 0
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) // 2
        i = bisect.bisect_right(starts, mid) - 1
        total += s1 - e0
        if i < 0 or covered[i][1] < mid:
            left += s1 - e0
    return 100.0 * left / total if total > 0 else None
