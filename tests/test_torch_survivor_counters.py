"""The survivor counters of StreamDecoder._postprocess_one, on the CPU: with
the switch on, `grid_survivors` and `survivors_decoded` sum each window's
`num_survivors` and min(num_survivors, K) over the windows that
cli.decode_throughput post-processed; on the full-demod path `num_survivors`
is the exact count of the grid's rows under the nbadsync threshold, as the
plain full demod of every candidate gives them; min(num_survivors, K) bounds
the rows BP takes, and equals them where every pattern's survivors fill its
quota or every pattern's fit in it; with the switch off nothing is counted.
A narrow deep-style grid (F = 11, depth 6, nbadsync 3: 528 candidates);
K = 16 overflows every window, K = 400 leaves some patterns' quotas short
while others overflow, K = 528 takes every candidate."""

import contextlib
import functools
import io
from pathlib import Path

import numpy as np
import pytest
import torch

from msk144cudecoder_tpu_torch import cli, stimulus
from msk144cudecoder_tpu_torch.config import DecoderConfig
from msk144cudecoder_tpu_torch.ops import demod, pipeline
from msk144cudecoder_tpu_torch.runtime import StreamDecoder, metrics

torch.set_num_threads(2)
K = 16
CFG = DecoderConfig(search_width=20.0, search_step=2.0, scan_depth=6, nbadsync_threshold=3,
                    survivor_prefilter=0, max_survivors=K)
N_WINDOWS = 10  # two whole batches of 4 and a padded tail of 2
KS = (16, 400, 528)


@pytest.fixture(scope="module")
def windows():
    raw = np.fromfile(Path(__file__).resolve().parents[1] / "demo" / "capture.raw",
                      dtype=np.int16)
    return np.stack(list(stimulus.stream_windows(raw))[:N_WINDOWS])


def config(k: int) -> DecoderConfig:
    return CFG.replace(max_survivors=k)


@functools.lru_cache(maxsize=None)
def stages(k: int, windows_key: bytes):
    """Per window of one eager pass at K = k: num_survivors, the rows the
    survivor choice hands BP as valid, and each pattern's survivors."""
    windows = np.frombuffer(windows_key, dtype=np.int16).reshape(N_WINDOWS, -1).copy()
    pipe = pipeline.DecodePipeline(config(k))
    with torch.no_grad():
        c = pipe.preprocess(torch.from_numpy(windows))
        pos, xb = pipe.scan(c)
        front = pipe.prefilter(pos, xb)
        sb, nbad = pipe.demod(c, front)
        prep = pipe.select(sb, nbad, front)
    under = nbad <= CFG.nbadsync_threshold
    per_pattern = torch.stack([(under & (front[3] == p)).sum(dim=-1)
                               for p in range(CFG.scan_depth)], dim=-1)
    return (prep.num_survivors.numpy(), prep.valid.sum(dim=-1).numpy(), per_pattern.numpy())


@pytest.fixture(scope="module")
def num_survivors(windows):
    """Each window's num_survivors from one eager pass of the pipeline."""
    return stages(K, windows.tobytes())[0]


@pytest.fixture
def switch(monkeypatch):
    def turn(on: bool):
        # off first, so that turning on starts a new recording whatever an
        # earlier test left on
        monkeypatch.setenv(metrics.ENV, "0")
        metrics.refresh()
        monkeypatch.setenv(metrics.ENV, "1" if on else "0")
        metrics.refresh()

    yield turn
    monkeypatch.setenv(metrics.ENV, "0")
    metrics.refresh()


def throughput(windows, k: int = K):
    """cli.decode_throughput over the windows, output dropped; returns the
    decoder."""
    dec = StreamDecoder(config(k), "cpu")
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        cli.decode_throughput(dec, iter(list(windows)), 4, 2)
    return dec


@pytest.mark.parametrize("k", KS)
def test_counters_sum_the_post_processed_windows_survivors(switch, windows, k):
    switch(True)
    dec = throughput(windows, k)
    counters = metrics.recorder().counters
    n = stages(k, windows.tobytes())[0]
    assert dec.survivor_capacity == k
    assert counters["grid_survivors"] == int(n.sum())
    assert counters["survivors_decoded"] == int(np.minimum(n, k).sum())
    if k == K:
        assert (n > K).all() and counters["survivors_decoded"] == K * N_WINDOWS
    if k == CFG.num_candidates:
        assert counters["survivors_decoded"] == counters["grid_survivors"]


@pytest.mark.parametrize("k", KS)
def test_survivors_decoded_bounds_the_rows_bp_takes(windows, k):
    n, taken, per_pattern = stages(k, windows.tobytes())
    quota = np.array(pipeline.split_quota(k, CFG.scan_depth))
    exact = (per_pattern >= quota).all(axis=1) | (per_pattern <= quota).all(axis=1)
    counted = np.minimum(n, k)
    assert (counted >= taken).all()
    assert np.array_equal(counted == taken, exact)
    assert np.array_equal(taken, np.minimum(per_pattern, quota).sum(axis=1))
    assert exact.all() == (k != 400)  # at 400 some windows count more than BP takes


def test_full_path_num_survivors_is_the_exact_count_of_the_grid(windows, num_survivors):
    pipe = pipeline.DecodePipeline(CFG)
    assert pipe.pre == 0
    c = pipe.preprocess(torch.from_numpy(windows))
    pos, _ = pipe.scan(c)
    _, nbad = demod.demod_candidates_plain(c, pipe.W, pos, pipe.demod_tables, False)
    assert nbad.shape == (N_WINDOWS, 11, 6, 8)
    exact = (nbad <= CFG.nbadsync_threshold).reshape(N_WINDOWS, -1).sum(dim=1).numpy()
    assert np.array_equal(num_survivors, exact)


def test_switch_off_counts_nothing(switch, windows):
    switch(True)  # a new recording
    switch(False)
    throughput(windows[:4])
    counters = metrics.recorder().counters
    assert "grid_survivors" not in counters and "survivors_decoded" not in counters
