"""The deep_full.recording cell and its two readers: `demod_roofline.recording`
(B4's bound over the mean `demod_kernel` launch of the slice) and
`survivor_cover.recording` (100 x `survivors_decoded` / `grid_survivors`),
on stub runs and on a small traced CPU run of the cell on a narrow grid.
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

from bench_torch.common import harness, program, reference, roofline, trace  # noqa: E402

CELL = "deep_full.recording"
READERS = ("demod_roofline.recording", "survivor_cover.recording")
SMALL = dict(window_batch=4, pipeline_depth=2, warmup_windows=8, check_windows=16,
             profile_start=0.2, profile_seconds=2.0, freq_margin_hz=5.0)
# F = 41 at deep's 1 Hz step (1968 candidates), K under its survivors
NARROW = dict(search_width=40.0, max_survivors=256)


def stub_run(driver="throughput", slice_=None):
    cell = harness.Cell(CELL)
    return SimpleNamespace(cell=SimpleNamespace(traffic={**cell.traffic, "driver": driver}),
                           settings=reference.Settings.from_config(cell.config["decoder"]),
                           slice=slice_)


def test_the_cell_loads_with_both_readers():
    cell = harness.Cell(CELL)
    names = [m["name"] for m in cell.per_layer]
    assert set(READERS) <= set(names) and "survivor_roofline.recording" not in names
    assert [m["name"] for m in cell.end_to_end] == ["realtime_factor", "setup_s"]
    decoder = cell.config["decoder"]
    assert decoder["survivor_prefilter"] == 0 and cell.config["reduced"] == ["max_survivors"]
    assert 256 < decoder["max_survivors"] < 501 * 6 * 8
    assert cell.limits == harness.Cell("deep.recording").limits
    assert all(callable(harness.reader(m)) for m in READERS)


def test_demod_bound_of_the_cell_is_the_kernel_tables():
    ms, by = roofline.demod_bound(64, 501, 6, 8)
    assert by == "bytes" and round(ms, 4) == 0.2459


def test_demod_roofline_reads_the_demod_kernel_launches():
    read = harness.reader("demod_roofline.recording")
    s = trace.Slice("cuda")
    assert read(stub_run()) is None  # no slice
    assert read(stub_run(slice_=s)) is None  # a slice not taken
    s.done = True
    s.device = [trace.Op("void survivor_kernel<false>(float2 const*)", 0, 10**6),
                trace.Op("void scan_kernel(float2 const*)", 0, 10**6)]
    assert read(stub_run(slice_=s)) is None  # no B4 launch
    bound_ms, _ = roofline.demod_bound(64, 501, 6, 8)
    s.device += [trace.Op("void demod_kernel<false>(float2 const*, int const*)", 0, 2_400_000),
                 trace.Op("void demod_kernel<true>(float2 const*, int const*)", 0, 2_600_000)]
    assert read(stub_run(slice_=s)) == pytest.approx(100.0 * bound_ms / 2.5)
    assert read(stub_run("live", s)) is None


def test_survivor_cover_reads_its_counters_and_none_without_them(monkeypatch):
    read = harness.reader("survivor_cover.recording")
    monkeypatch.setattr(program, "recorder", lambda: None)
    assert read(stub_run()) is None
    counters = {}
    monkeypatch.setattr(program, "recorder", lambda: SimpleNamespace(counters=counters))
    assert read(stub_run()) is None  # a program older than the counters
    counters.update(grid_survivors=0, survivors_decoded=0)
    assert read(stub_run()) is None
    counters.update(grid_survivors=14_400, survivors_decoded=256)
    assert read(stub_run()) == pytest.approx(100.0 * 256 / 14_400)
    assert read(stub_run("live")) is None


def test_a_traced_cpu_run_of_the_cell_reads_the_programs_counters():
    """Read at once after the run: the port's recorder holds only the latest
    traced window. The CPU slice has no device ops, so no B4 launch."""
    import torch

    torch.set_num_threads(4)
    got = {}
    orig = harness.reader

    def spy(name):
        read = orig(name)

        def keep(run):
            if not got:
                got.update({m: orig(m)(run) for m in READERS})
                got["counters"] = dict(program.recorder().counters)
                got["compared"] = run.check["info"]["windows_compared"]
            return read(run)

        return keep

    harness.reader = spy
    try:
        out = harness.run_cell(CELL, 2 ** 31 + 23, 3.0, True, "cpu", time.perf_counter(),
                               hops=160, traffic_overrides=SMALL, config_overrides=NARROW)
    finally:
        harness.reader = orig
    assert out["correct"], out
    counters = got["counters"]
    assert got["compared"] > 0 and got["demod_roofline.recording"] is None
    assert counters["grid_survivors"] > counters["survivors_decoded"] > 0
    assert got["survivor_cover.recording"] == pytest.approx(
        100.0 * counters["survivors_decoded"] / counters["grid_survivors"])
