"""Per-window result deduplication and output formatting.

Mirror of reference src/result_filter.cpp: within one working-loop block,
group decoded messages by text and keep the best occurrence (lowest num_avg,
then lowest nbadsync). The stdout line format reproduces main.cu:406-419
exactly — it is the reference's public API for downstream consumers.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List


@dataclass
class ResultItem:
    snr: int
    f0: float
    num_avg: int
    nbadsync: int
    pattern_idx: int
    message: str
    update_stamp: float = field(default_factory=time.time)

    def stamp_string(self) -> str:
        return time.strftime("%Y%m%d%H%M%S", time.localtime(self.update_stamp))

    def format_line(self) -> str:
        """The stdout decode line (main.cu:406-419): `***  snr=%2d; f0=%6g; ...`."""
        return (
            "***  "
            f"snr={self.snr:2d}; "
            f"f0={self.f0:6g}; "
            f"num_avg={self.num_avg}; "
            f"nbadsync={self.nbadsync}; "
            f"pattern_idx={self.pattern_idx}; "
            f"date={self.stamp_string()}; "
            f"msg='{self.message}'; "
        )


class ResultFilter:
    def __init__(self) -> None:
        self._block_scope: List[ResultItem] = []
        self._block_result: List[ResultItem] = []

    def block_begin(self) -> None:
        self._block_scope = []

    def put_message(
        self, snr: int, f0: float, num_avg: int, nbadsync: int, pattern_idx: int, message: str
    ) -> None:
        self._block_scope.append(ResultItem(snr, f0, num_avg, nbadsync, pattern_idx, message))

    def block_end(self) -> None:
        self._block_result = []
        for msg in sorted({item.message for item in self._block_scope}):
            group = [it for it in self._block_scope if it.message == msg]
            group.sort(key=lambda it: (it.num_avg, it.nbadsync))
            self._block_result.append(group[0])

    def block_result(self) -> List[ResultItem]:
        return list(self._block_result)
