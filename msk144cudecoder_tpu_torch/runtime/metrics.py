"""Wall-clock metrics and the real-time budget monitor.

Mirror of reference src/metrics.{h,cpp}: `SimpleTimer` is the always-on
elapsed-ms reader behind the 210 ms soft-budget warning (main.cu:398-403);
`ScopedMetric` is the nesting RAII span printer, enabled by the
MSK144_TPU_METRICS environment variable (the JAX package's switch, so one
setting instruments both) instead of a compile-time define.
"""

from __future__ import annotations

import os
import sys
import time


def metrics_enabled() -> bool:
    return os.environ.get("MSK144_TPU_METRICS", "0") not in ("0", "", "false")


class SimpleTimer:
    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()

    def milliseconds_elapsed(self) -> float:
        return (time.perf_counter() - self._t0) * 1000.0


_depth = 0


class ScopedMetric:
    """Prints `Measured time: <name> <ms>` on stop, indented by nesting level
    (metrics.cpp:35-46). Usable as a context manager or via explicit stop()."""

    def __init__(self, name: str, level: int | None = None) -> None:
        global _depth
        self._name = name
        self._level = _depth if level is None else level
        self._timer = SimpleTimer()
        self._stopped = not metrics_enabled()
        if not self._stopped:
            _depth += 1

    def stop(self) -> None:
        global _depth
        if self._stopped:
            return
        self._stopped = True
        _depth -= 1
        ms = self._timer.milliseconds_elapsed()
        print(f"{'  ' * self._level}Measured time: {self._name} {ms:.3f} ms", file=sys.stderr)

    def __enter__(self) -> "ScopedMetric":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
