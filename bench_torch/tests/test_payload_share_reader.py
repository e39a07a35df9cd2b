"""The `payload_share.recording` reader: 100 x `unpack_payloads` /
`unpack_lookups`, on planted counters and on a small traced CPU run of the
throughput driver, where a payload's rows after its first are memo hits.
Run from the repository root:

    python -m pytest bench_torch/tests -q
"""

from __future__ import annotations

import pathlib
import sys
import time
from types import SimpleNamespace

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_torch.common import harness, program  # noqa: E402

SMALL = dict(window_batch=4, pipeline_depth=2, warmup_windows=8, check_windows=16,
             profile_start=0.2, profile_seconds=2.0)


def test_payload_share_reads_its_counters_and_none_without_them(monkeypatch):
    """None on a program that keeps no `unpack_payloads` counter (one older
    than the grouped unpack), on no lookups, and for the live driver."""
    read = harness.reader("payload_share.recording")
    counters = {}
    monkeypatch.setattr(program, "recorder", lambda: SimpleNamespace(counters=counters))
    run = SimpleNamespace(cell=SimpleNamespace(traffic={"driver": "throughput"}))
    assert read(run) is None
    counters.update(unpack_lookups=12)
    assert read(run) is None
    counters.update(unpack_payloads=3)
    assert read(run) == pytest.approx(25.0)
    run.cell.traffic["driver"] = "live"
    assert read(run) is None


def test_payload_share_agrees_with_the_memo_hits_of_a_traced_run():
    """Read at once after the run: the port's recorder holds only the latest
    traced window."""
    import torch

    torch.set_num_threads(4)
    got = {}
    orig = harness.reader

    def spy(name):
        read = orig(name)

        def keep(run):
            if not got:
                got.update({m: orig(m)(run) for m in
                            ("payload_share.recording", "memo_hit_share.recording")})
            return read(run)

        return keep

    harness.reader = spy
    try:
        harness.run_cell("default.recording_busy", 2 ** 31 + 11, 3.0, True, "cpu",
                         time.perf_counter(), hops=160, traffic_overrides=SMALL)
    finally:
        harness.reader = orig
    share, hits = got["payload_share.recording"], got["memo_hit_share.recording"]
    assert isinstance(share, float) and 0 < share <= 100
    assert hits >= 100 - share - 1e-9
