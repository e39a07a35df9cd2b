"""CPU rehearsal of the benchmark: its files, its yardstick and its guards.

Run from the repository root (not part of the repository's test suite):

    python -m pytest bench_torch/tests -q
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench_torch"
sys.path.insert(0, str(ROOT))

from bench_torch.common import drivers, generator, harness, reference, roofline  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_by_name(cell):
    c = harness.Cell(cell)
    driver = drivers.load(c.traffic["driver"])
    assert callable(driver.warm) and callable(driver.run)
    assert "unanswered" in c.limits
    reference.Settings.from_config(c.config["decoder"])
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.reader(m["name"]))


@pytest.mark.parametrize("mix", sorted(p.stem for p in (BENCH / "traffic").glob("*.json")))
def test_generator_same_seed_same_bytes(mix):
    traffic = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
    freqs = reference.Settings.from_config({}).freqs
    a = generator.make(2 ** 31 + 7, traffic, freqs, hops=48)
    b = generator.make(2 ** 31 + 7, traffic, freqs, hops=48)
    c = generator.make(5, traffic, freqs, hops=48)
    assert a.audio.tobytes() == b.audio.tobytes() and a.pings == b.pings
    assert a.audio.tobytes() != c.audio.tobytes()
    assert len({p.text for p in a.pings}) == len(a.pings)
    assert len(a.pings) == len(c.pings)


def test_generator_matches_port_stimulus():
    from msk144cudecoder_tpu_torch import stimulus

    from bench_torch.common.proto import msg77

    text = "K1ABC W9XYZ EN37"
    bits = generator.frame_bits77(msg77.pack77(text)[None])[0]
    assert np.array_equal(bits, stimulus.frame_bits_from_message(text))
    assert np.array_equal(generator.modulate_frame(bits).view(np.uint64),
                          stimulus.modulate_frame(bits).view(np.uint64))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_check", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("F, depth, want", [(101, 4, 0.0468), (501, 6, 0.2419)])
def test_scan_bound_matches_chip_smoke(F, depth, want):
    ms, by = roofline.scan_bound(64, F, depth, 8, 4)
    assert (ms, by) == _chip_smoke().scan_bound(64, F, depth, 8, 4)
    assert by == "operations" and round(ms, 4) == want


@pytest.mark.parametrize("F, depth, want", [(101, 4, 0.0150), (501, 6, 0.0183)])
def test_survivor_bound_matches_perf_table(F, depth, want):
    ms, by = roofline.survivor_bound(64, 512, F, depth)
    assert by == "operations" and round(ms, 4) == want


@pytest.mark.parametrize("n_win, F, depth, want", [(64, 501, 6, 0.2459), (8, 101, 4, 0.0054)])
@pytest.mark.parametrize("fast", [False, True])
def test_demod_bound_matches_chip_smoke(n_win, F, depth, want, fast):
    """chip_smoke.py's B4 count (phase 2), on tensors of the kernel's shapes
    that hold no data, and the bound in PERF.md's table of kernels."""
    import torch

    from msk144cudecoder_tpu_torch.ops import tables

    cs = _chip_smoke()
    k, N = 8, reference.C.WINDOW_LEN
    rows = n_win * F * depth * k

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    args = (meta((n_win, N), torch.complex64), meta((F, N), torch.complex64),
            meta((n_win, F, depth, k), torch.int32), *tables.demod_to_torch("cpu"),
            meta((n_win, F, depth, k, 128), torch.float32), meta((n_win, F, depth, k), torch.int32))
    want_ms, want_by = cs.bound(
        **cs.split_ops(fast, f32=n_win * F * N * (6 + 2 * depth) + cs.TAIL_F32_FLOPS * rows,
                       dot=cs.TAIL_DOT_FLOPS * rows),
        nbytes=cs.tensor_bytes(*args))
    ms, by = roofline.demod_bound(n_win, F, depth, k, fast)
    assert (ms, by) == (want_ms, want_by)
    assert by == "bytes" and round(ms, 4) == want


def test_importing_the_benchmark_pulls_in_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import bench_torch.run\n"
            "from bench_torch.common import harness, compare, drivers, generator, trace\n"
            "import json\n"
            "spec = json.load(open(%r))\n"
            "[harness.reader(m['name']) for m in spec['end_to_end'] + spec['per_layer']]\n"
            "[drivers.load(harness.Cell(w['name']).traffic['driver']) for w in spec['workloads']]\n"
            "import msk144cudecoder_tpu_torch.cli, msk144cudecoder_tpu_torch.runtime\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'msk144cudecoder_tpu' or m.startswith('msk144cudecoder_tpu.')]\n"
            "assert not bad, bad\n") % (str(ROOT), str(ROOT / "BENCHMARK.json"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_run_exits_nonzero_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    proc = subprocess.run([sys.executable, "bench_torch/run.py", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_run_refuses_without_the_native_framer(monkeypatch):
    from msk144cudecoder_tpu_torch.runtime import native

    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(SystemExit, match="native framer"):
        harness.run_cell(CELLS[0], 1, 1.0, False, "cpu", 0.0, hops=48)
