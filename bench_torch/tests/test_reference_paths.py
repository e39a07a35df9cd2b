"""The plain reference's two paths on the CPU, held to the port and to itself.

The full-demod path (`survivor_prefilter` 0) gives the port's own CPU
decode (`DecodePipeline`, its kernels' plain versions) exactly, field by
field, in each of the three orders the survivor choice can take; the
prefilter path, which the benchmark's cells run, still gives the rows it
gave when the full-demod path was added (a digest of them). Run from the
repository root:

    python -m pytest bench_torch/tests -q
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench_torch"
sys.path.insert(0, str(ROOT))

from bench_torch.common import generator, reference  # noqa: E402
from bench_torch.common.proto import constants as C  # noqa: E402

SEED = 20261018


def decoder_kw(config: str, **extra) -> dict:
    return {**json.loads((BENCH / "configs" / f"{config}.json").read_text())["decoder"], **extra}


def windows(settings: reference.Settings) -> np.ndarray:
    """Eight windows of a crowded band (a ping per hop), three hops apart."""
    traffic = json.loads((BENCH / "traffic" / "recording_busy.json").read_text())
    rec = generator.make(SEED, traffic, settings.freqs, hops=48)
    return np.stack([rec.window(i) for i in range(0, 24, 3)])


def port_rows(kw: dict, raw: np.ndarray) -> dict:
    """The port's CPU decode of raw, stage by stage, as the reference's Rows
    fields."""
    from msk144cudecoder_tpu_torch.config import DecoderConfig
    from msk144cudecoder_tpu_torch.ops import pipeline

    pipe = pipeline.DecodePipeline(DecoderConfig(**kw))
    with torch.no_grad():
        c = pipe.preprocess(torch.from_numpy(raw))
        pos, xb = pipe.scan(c)
        front = pipe.prefilter(pos, xb)
        sb, nbad = pipe.demod(c, front)
        prep = pipe.select(sb, nbad, front)
        bp = pipe.bp(prep)
        res = pipe.finish(prep, bp, c)
    updates = torch.where(bp.found, bp.iterations,
                          torch.where(prep.valid, C.NUM_BP_ITERATIONS, 0)).sum(dim=-1)
    return dict(cand_index=res.cand_index, found=res.found,
                message_bits=pipeline.unpack_message_bits(res.message_bits.numpy()),
                nbadsync=res.nbadsync, xb=res.xb, pos=res.pos, block_power=res.block_power,
                bp_updates=updates)


@pytest.mark.parametrize("extra, block_cells", [
    ({}, None),  # threshold 1, depth 4: a masked quota a pattern
    ({}, 3),  # the same in blocks of 3 (window, frequency) cells
    ({"nbadsync_threshold": 5}, None),  # two keys over the whole grid
    ({"scan_depth": 1}, None),  # the single key over the whole grid
])
def test_full_demod_path_equals_the_port(monkeypatch, extra, block_cells):
    torch.set_num_threads(4)
    kw = decoder_kw("default", survivor_prefilter=0, **extra)
    settings = reference.Settings.from_config(kw)
    ref = reference.ReferenceDecoder(settings, "cpu")
    assert ref.pre == 0
    if block_cells:
        P, k = settings.scan_depth, settings.candidates_per_pattern
        monkeypatch.setattr(reference, "_FULL_BLOCK_BYTES", block_cells * P * k * C.FRAME_LEN * 8)
    raw = windows(settings)
    rows = ref.decode(raw)
    assert rows.found.any()
    want = port_rows(kw, raw)
    for name in reference.Rows._fields:
        got, exp = getattr(rows, name), np.asarray(want[name])
        assert got.dtype == exp.dtype and got.shape == exp.shape, name
        assert np.array_equal(got, exp), name


def rows_digest(rows: reference.Rows) -> str:
    h = hashlib.sha256()
    for name in rows._fields:
        a = np.ascontiguousarray(getattr(rows, name))
        h.update(f"{name}{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("config, digest", [
    ("default", "ab0df77a5609d55ed7c50515292b3dd823a6eb3b5b2b7519e8767b618505494a"),
    ("deep", "2a32b6e50c03e757724a2b6d486046151be12abf53fce29d376791f589995681"),
])
def test_prefilter_path_rows_are_pinned(config, digest):
    """The Rows of the cells' path on fixed windows, as the reference gave
    them before its full-demod path was added (x86-64 CPU, torch's CPU
    kernels): an edit that moves the cells' reference fails here."""
    torch.set_num_threads(4)
    settings = reference.Settings.from_config(decoder_kw(config))
    ref = reference.ReferenceDecoder(settings, "cpu")
    assert ref.pre > 0
    assert rows_digest(ref.decode(windows(settings))) == digest
