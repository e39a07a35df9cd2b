"""The check that decides `correct`, driven on the CPU at a small size.

A sound run of the port (its kernels' plain versions on the CPU) comes out
correct; the control (the port's bf16 mode) and each fault a cell can have,
planted under the timed path, come out not correct. Everything of a run but
the look for a card runs: the recording, the framer, the driver, the
reference and the limits of the cell. Run from the repository root:

    python -m pytest bench_torch/tests -q
"""

from __future__ import annotations

import pathlib
import sys
import time

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_torch.common import harness  # noqa: E402

# small: 8-window batches, 2 workers, a short recording
SMALL = {"throughput": dict(window_batch=8, pipeline_depth=2, warmup_windows=16,
                            check_windows=48),
         "live": dict(warmup_windows=4, check_windows=48)}
RECORDING = "default.recording_busy"
LIVE = "default.live"


# the full-demod path: every candidate demodulated (kernel B4 on a card)
FULL = {"survivor_prefilter": 0}


def run(cell, base=None, control=False, seconds=2.0, config=None):
    import torch

    torch.set_num_threads(4)
    driver = harness.Cell(cell).traffic["driver"]
    return harness.run_cell(cell, 20240917, seconds, False, "cpu", time.perf_counter(),
                            control=control, decoder_base=base, hops=160,
                            traffic_overrides=SMALL[driver], config_overrides=config)


def port_decoder():
    from msk144cudecoder_tpu_torch.runtime import StreamDecoder

    return StreamDecoder


def stale_state():
    """Every pass returns the first pass's result: a step that leaves its
    state unchanged."""
    class Stale(port_decoder()):
        first = None

        def _run(self, raw_batch):
            if Stale.first is None:
                Stale.first = super()._run(raw_batch)
            return Stale.first

    return Stale


def half_batch():
    """The second half of each batch's windows never reaches the decode."""
    class Half(port_decoder()):
        def _run(self, raw_batch):
            raw = np.array(raw_batch)
            raw[len(raw) // 2:] = 0
            return super()._run(raw)

    return Half


def altered_answer():
    """One bit of each window's first decoded payload flipped where the
    device pass hands it over."""
    class Altered(port_decoder()):
        def _postprocess_one(self, res, b):
            bits = np.asarray(res.message_bits)
            bits[b, 0, 3] ^= 0x10
            return super()._postprocess_one(res, b)

    return Altered


@pytest.mark.parametrize("cell", [RECORDING, LIVE])
def test_sound_run_is_correct(cell):
    out = run(cell)
    assert out["correct"], out["checks"]
    assert out["checks"]["xb_gap"]["value"] == 0.0


def test_control_is_refused():
    """The reference put in the program's place at the precision below the
    configuration's: the port's bf16 mode."""
    out = run(RECORDING, control=True)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell, fault", [
    (RECORDING, stale_state), (RECORDING, half_batch), (RECORDING, altered_answer),
    (LIVE, stale_state), (LIVE, altered_answer)])
def test_fault_is_refused(cell, fault):
    out = run(cell, base=fault())
    assert not out["correct"], out["checks"]


def test_sound_run_of_the_full_demod_path_is_correct():
    out = run(RECORDING, config=FULL)
    assert out["correct"], out["checks"]
    assert out["checks"]["xb_gap"]["value"] == 0.0
    assert out["info"]["check"]["rows_found_both"] > 0


def test_control_of_the_full_demod_path_is_refused():
    out = run(RECORDING, control=True, config=FULL)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [altered_answer, stale_state])
def test_fault_on_the_full_demod_path_is_refused(fault):
    out = run(RECORDING, base=fault(), config=FULL)
    assert not out["correct"], out["checks"]
