"""The device trace of a traced run: torch.profiler over a steady slice.

`Slice` starts and stops the profiler around a slice of the measured window
and keeps what the per-layer readers need: every device operation (kernel,
copy, memset) as (name, start, duration) on the trace's clock, every host
event beside them, and the slice's length by the host clock. The device's
busy time is the union of its operations' intervals, not their sum: the
throughput driver's workers run kernels on several streams at once.
"""

from __future__ import annotations

import heapq
import re
import time
from typing import Dict, List, NamedTuple, Tuple


class Op(NamedTuple):
    name: str
    start_ns: int
    dur_ns: int


def short_name(name: str) -> str:
    """A kernel's name without its template arguments and signature."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return re.sub(r"[(<].*", "", name)[:64] or name[:64]


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merged (start, end) intervals, sorted."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class Slice:
    """One profiled slice. `start()` and `stop()` are called from the
    driver's loop; after stop, `device` holds the device ops, `host` the
    host events, `window_s` the slice's length and `passes` the calls into
    the entry that began inside it."""

    def __init__(self, device_type: str):
        self.device_type = device_type
        self.device: List[Op] = []
        self.host: List[Op] = []
        self.window_s = 0.0
        self.passes = 0
        self.active = False
        self.done = False
        self._prof = None
        self._t0 = 0.0

    def warm(self) -> None:
        """Start and stop the profiler once, so that its first start (CUPTI's
        set-up, seconds) falls in the run's set-up and not in the slice."""
        self.start()
        self._prof.stop()
        self._prof = None
        self.active = False

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device_type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        if self.device_type == "cuda":
            torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        self.active = True

    def stop(self) -> None:
        import torch
        from torch.autograd import DeviceType

        if self.device_type == "cuda":
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.stop()
        self.active = False
        self.done = True
        for e in self._prof.profiler.kineto_results.events():
            op = Op(e.name(), int(e.start_ns()), int(e.duration_ns()))
            if e.device_type() != DeviceType.CUDA:
                self.host.append(op)
            elif not e.is_user_annotation():  # a label's range on the device's row
                self.device.append(op)
        self._prof = None

    def elapsed(self) -> float:
        """Seconds since the slice started."""
        return time.perf_counter() - self._t0

    # -- readings -----------------------------------------------------------

    def busy_intervals(self) -> List[Tuple[int, int]]:
        return union([(o.start_ns, o.start_ns + o.dur_ns) for o in self.device])

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernel_ns(self, pattern: str) -> Tuple[int, int]:
        """(total ns, launches) of the device ops whose name matches."""
        rx = re.compile(pattern)
        hits = [o.dur_ns for o in self.device if rx.search(o.name)]
        return sum(hits), len(hits)

    def top_ops(self, n: int = 10) -> List[List]:
        """The device ops that took most time, [short name, seconds]."""
        acc: Dict[str, int] = {}
        for o in self.device:
            k = short_name(o.name)
            acc[k] = acc.get(k, 0) + o.dur_ns
        return [[k, v / 1e9] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The device's idle time between its first and last op, summed by
        the innermost host event under each gap's middle, [name, seconds];
        "host: no traced op" where none is. The innermost event is taken as
        the latest-started one that still runs at that point."""
        busy = self.busy_intervals()
        host = sorted(self.host, key=lambda o: o.start_ns)
        gaps = sorted(((e0 + s1) // 2, s1 - e0) for (_, e0), (s1, _) in zip(busy, busy[1:]))
        acc: Dict[str, int] = {}
        live: List[Tuple[int, int, str]] = []  # max-heap by start: (-start, end, name)
        j = 0
        for mid, length in gaps:
            while j < len(host) and host[j].start_ns <= mid:
                o = host[j]
                heapq.heappush(live, (-o.start_ns, o.start_ns + o.dur_ns, o.name))
                j += 1
            # the gaps come in order, so an event that ended before this
            # gap's middle has ended before every later one's too
            while live and live[0][1] < mid:
                heapq.heappop(live)
            k = short_name(live[0][2]) if live else "host: no traced op"
            acc[k] = acc.get(k, 0) + length
        return [[k, v / 1e9] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]
