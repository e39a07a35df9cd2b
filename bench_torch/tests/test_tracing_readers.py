"""The readers of the program's spans and counters, on a small CPU run of
each driver with tracing on: each of the eight reads a number for its own
driver and None for the other; a gap under a request root alone (a drain's
own time) reads as untraced. The CPU trace has no device operations, so
`untraced_idle.*` is read on device operations planted around the run's own
`msk144.*` ranges: one gap under a range, one after the last. Run from the
repository root:

    python -m pytest bench_torch/tests -q
"""

from __future__ import annotations

import pathlib
import sys
import time

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_torch.common import harness, program, trace  # noqa: E402

SMALL = {"throughput": dict(window_batch=4, pipeline_depth=2, warmup_windows=8,
                            check_windows=16, profile_start=0.2, profile_seconds=2.0),
         "live": dict(warmup_windows=4, check_windows=16, profile_start=0.2, profile_seconds=1.0)}
CELLS = {"throughput": "default.recording_busy", "live": "default.live"}
READERS = {"live": ["h2d_ms.live", "launch_ms.live", "untraced_idle.live"],
           "throughput": ["result_wait_ms.recording", "unpack_ms_per_window.recording",
                          "memo_hit_share.recording", "graph_capture_ms.recording",
                          "untraced_idle.recording"]}


def plant_gaps(s: trace.Slice):
    """Device ops around one gap centred in the longest `msk144.*` range and
    one centred after the last; returns the uncovered gap's share in %."""
    ranges = program.ranges(s)
    a, b = max(ranges, key=lambda r: r[1] - r[0])
    covered_mid, g = (a + b) // 2, max((b - a) // 4, 1)
    free_mid, g2 = ranges[-1][1] + 10_000, 2_000
    s.device = [trace.Op("k0", covered_mid - g - 1_000, 1_000),
                trace.Op("k1", covered_mid + g, free_mid - g2 - covered_mid - g),
                trace.Op("k2", free_mid + g2, 1_000)]
    return 100.0 * 2 * g2 / (2 * g + 2 * g2)


@pytest.fixture(scope="module", params=["live", "throughput"])
def traced(request):
    """(driver, {metric: reading}) of one traced CPU run, read at once: the
    port's recorder holds only the latest traced window."""
    import torch

    torch.set_num_threads(4)
    driver = request.param
    runs = []
    orig = harness.reader

    def spy(name):
        read = orig(name)

        def keep(run):
            runs.append(run)
            return read(run)

        return keep

    harness.reader = spy
    try:
        harness.run_cell(CELLS[driver], 2 ** 31 + 11, 3.0, True, "cpu", time.perf_counter(),
                         hops=160, traffic_overrides=SMALL[driver])
    finally:
        harness.reader = orig
    run = runs[0]
    assert run.slice is not None and run.slice.done and not run.slice.device
    got = {m: orig(m)(run) for names in READERS.values() for m in names}
    roots = [(o.start_ns, o.start_ns + o.dur_ns) for o in run.slice.host if o.name in program.ROOTS]
    share = plant_gaps(run.slice)
    for m in READERS[driver]:
        if m.startswith("untraced_idle"):
            got[m] = (orig(m)(run), share)
    return driver, got, run, roots


def test_each_reader_reads_its_own_driver_and_none_for_the_other(traced):
    driver, got, _, _ = traced
    for d, names in READERS.items():
        for m in names:
            value = got[m]
            if d != driver:
                assert value is None, (m, value)
            elif m.startswith("untraced_idle"):
                read, planted = value
                assert read == pytest.approx(planted), m
            else:
                assert isinstance(value, float) and value >= 0, (m, value)


def test_readings_agree_with_the_run(traced):
    driver, got, run, _ = traced
    info = run.check["info"]
    if driver == "live":
        assert got["launch_ms.live"] > got["h2d_ms.live"] > 0  # the eager pass on the CPU
        assert "launch_ms_slice" in info and "launch_ms_outside_slice" in info
    else:
        assert 0 < got["memo_hit_share.recording"] <= 100
        assert got["graph_capture_ms.recording"] == 0.0 and info["graph_captures"] == 0
        assert 0 <= info["result_wait_drain_first"] <= 1


def test_a_gap_under_a_request_root_alone_is_untraced(traced):
    """A drain's time outside its children (the CLI's bookkeeping, the
    harness's hooks) names no activity: a gap there counts as untraced."""
    driver, _, run, roots = traced
    if driver == "live":
        assert not roots  # decode_block is a request, not a span
        return
    assert roots, "no msk144.drain range in the throughput driver's slice"
    covered = program.ranges(run.slice)
    for a, b in roots:
        inside = [(max(x, a), min(y, b)) for x, y in covered if x < b and y > a]
        free = [(p, q) for (_, p), (q, _) in zip([(a, a)] + inside, inside + [(b, b)]) if q - p > 2]
        if free:
            break
    else:
        pytest.skip("no drain range with free time outside its children")
    p, q = free[0]
    mid, g = (p + q) // 2, max((q - p) // 4, 1)
    run.slice.device = [trace.Op("k0", mid - g - 1_000, 1_000), trace.Op("k1", mid + g, 1_000)]
    assert program.untraced_idle(run.slice) == pytest.approx(100.0)
