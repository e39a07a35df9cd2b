"""The program's spans, and the sinks the measured window writes to.

With MSK144_TPU_METRICS=1 the port's `runtime.metrics.ScopedMetric` prints
`Measured time: <name> <ms> ms` to standard error when each span ends. In
the traced run the harness points standard error at a `SpanSink` for the
window: it sums each span's milliseconds by name and counts the other lines. `LineSink` takes the decode lines the entry prints.
"""

from __future__ import annotations

import re
from typing import Dict

_SPAN = re.compile(r"^\s*Measured time: (\S+) ([0-9.eE+-]+) ms\s*$")


class LineSink:
    """A text stream that counts the lines written to it."""

    def __init__(self):
        self.lines = 0
        self._buf = ""

    def write(self, s: str) -> int:
        self._buf += s
        *full, self._buf = self._buf.split("\n")
        for line in full:
            self.take(line)
        return len(s)

    def take(self, line: str) -> None:
        self.lines += 1

    def flush(self) -> None:
        pass


class SpanSink(LineSink):
    """Standard error of the traced window: the program's spans summed by
    name (`ms`), every other line counted."""

    def __init__(self):
        super().__init__()
        self.ms: Dict[str, float] = {}

    def take(self, line: str) -> None:
        m = _SPAN.match(line)
        if m is None:
            super().take(line)
            return
        name = m.group(1)
        self.ms[name] = self.ms.get(name, 0.0) + float(m.group(2))
