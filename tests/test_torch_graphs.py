"""The CUDA-graph layer of the PyTorch port (ops/graphs.py) and the CLIs'
precision switch, on the CPU: StreamDecoder on the CPU runs the pipeline
eagerly and builds no graph, GraphedPipeline refuses a CPU pipeline, the
packed result layout round-trips every field, a capture's launches go to
its tally (a replay adds it), the throughput mode keeps its tail batch at
the full shape (one graph per worker), the import guard covers the module,
and --fast-math selects the bf16 mode in both port CLIs. The graphs
themselves run on the card: tests/test_torch_gpu.py holds them bit for bit
against the eager pass."""

import contextlib
import io
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from msk144cudecoder_tpu_torch import cli
from msk144cudecoder_tpu_torch import constants as C
from msk144cudecoder_tpu_torch.config import DecoderConfig
from msk144cudecoder_tpu_torch.ops import graphs, kernels, pipeline, scan
from msk144cudecoder_tpu_torch.parallel import cli as parallel_cli
from msk144cudecoder_tpu_torch.runtime import StreamDecoder
from msk144cudecoder_tpu_torch.runtime.decoder import to_host

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
DEMO = ROOT / "demo" / "capture.raw"
SMALL = ["--search-width=100", "--scan-depth=4"]
CFG = DecoderConfig(search_width=100.0, scan_depth=3)  # F = 51: the prefilter resolves on


@pytest.fixture(scope="module")
def demo_windows():
    from msk144cudecoder_tpu_torch import stimulus

    return stimulus.stream_windows(np.fromfile(DEMO, dtype=np.int16))


def test_stream_decoder_on_cpu_builds_no_graph(demo_windows):
    """On the CPU every entry point runs the eager pipeline: no graph, and
    the results of decode_to_host and submit/collect are the pipeline's."""
    dec = StreamDecoder(CFG, "cpu")
    batch = demo_windows[8:10]
    got = dec.decode_to_host(batch)
    want = to_host(pipeline.DecodePipeline(CFG)(torch.from_numpy(batch)))
    for f, x, y in zip(want._fields, got, want):
        np.testing.assert_array_equal(x, y, err_msg=f)
    dec.submit(batch[0])
    assert isinstance(dec._pending[0], pipeline.WindowDecodeResult)
    dec.collect()
    assert dec._graphed is None
    with pytest.raises(RuntimeError, match="runs eagerly"):
        dec.graphed


def test_graphed_pipeline_refuses_a_cpu_pipeline():
    with pytest.raises(ValueError, match="CUDA graphs need a pipeline on a CUDA device"):
        graphs.GraphedPipeline(pipeline.DecodePipeline(CFG))


@pytest.mark.parametrize("prefilter", [None, 0])
def test_packed_result_round_trips_every_field(demo_windows, prefilter):
    """pack and unpack give back every field, dtype and shape of a pass
    (4-byte fields first, each at an offset aligned for its type), on the
    device and through numpy()."""
    cfg = CFG.replace(survivor_prefilter=prefilter)
    res = pipeline.DecodePipeline(cfg)(torch.from_numpy(demo_windows[[2, 10, 20]]))
    layout = graphs.result_layout(res)
    packed = graphs.PackedResult(graphs.pack(res, layout), layout)
    assert packed.buf.dtype == torch.uint8
    assert packed.buf.numel() == sum(x.numel() * x.element_size() for x in res)
    assert all(o % torch.empty((), dtype=dt).element_size() == 0 for dt, _, o, _ in layout)
    for f, x, y in zip(res._fields, packed.unpack(), res):
        assert x.dtype == y.dtype and torch.equal(x, y), f
    for f, x, y in zip(res._fields, packed.numpy(), to_host(res)):
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert res.found.any()


def test_capture_records_launches_and_replay_adds_them(monkeypatch):
    """Under kernels.recording() a wrapper's count goes to the tally, not to
    the counts; add_launches adds a tally, as a replay does."""
    monkeypatch.setattr(scan.scan_cuda, "launches", 0)
    monkeypatch.setattr(scan.scan_cuda, "launches_fast", 0)
    with kernels.recording() as tally:
        kernels.count_launch(scan.scan_cuda)
        kernels.count_launch(scan.scan_cuda, fast=True)
        kernels.count_launch(scan.scan_cuda, fast=True)
    assert tally == {(scan.scan_cuda, False): 1, (scan.scan_cuda, True): 2}
    assert (scan.scan_cuda.launches, scan.scan_cuda.launches_fast) == (0, 0)
    for _ in range(3):
        kernels.add_launches(tally)
    kernels.count_launch(scan.scan_cuda)  # outside the capture: counted
    assert kernels.launch_counts()["scan"] == 4
    assert kernels.launch_counts()["scan_fast"] == 6


def test_throughput_tail_keeps_the_batch_shape():
    """decode_throughput pads the stream's tail to the full batch, so every
    device call has one shape (one graph per worker on a card) and only the
    tail's real windows are post-processed."""
    raw_len = C.WINDOW_LEN
    windows = [np.full(raw_len, i, np.int16) for i in range(11)]
    shapes, posted = [], []

    class Recorder:
        def decode_to_host(self, batch):
            shapes.append(batch.shape)
            return batch

        def postprocess_batch(self, res, n):
            posted.append([int(w[0]) for w in res[:n]])
            return [[] for _ in range(n)]

    with contextlib.redirect_stderr(io.StringIO()):
        cli.decode_throughput(Recorder(), iter(windows), 4, 2)
    assert shapes == [(4, raw_len)] * 3
    assert posted == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10]]


def test_import_guard_covers_graphs():
    """ops/graphs.py pulls in neither jax nor the JAX package."""
    code = ("import sys\n"
            "import msk144cudecoder_tpu_torch.ops.graphs\n"
            "print([m for m in sys.modules if m.split('.')[0] in ('jax', 'msk144cudecoder_tpu')])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    text = (ROOT / "msk144cudecoder_tpu_torch" / "ops" / "graphs.py").read_text()
    assert not re.search(r"^\s*(import|from) (jax|msk144cudecoder_tpu)\b(?!_torch)", text, re.M)


@pytest.mark.parametrize("flags,fast", [([], False), (["--exact-math"], False),
                                        (["--fast-math"], True)])
def test_precision_flags_select_the_mode(flags, fast):
    """fp32 is the default and --exact-math's; --fast-math selects bf16, in
    the stream CLI and the parallel runner."""
    assert cli.config_from_args(cli.build_parser().parse_args(flags)).fast_math is fast
    args = parallel_cli.build_parser().parse_args(["--input", "x.raw", *flags])
    assert cli.config_from_args(args).fast_math is fast


def test_fast_and_exact_math_are_exclusive(capsys):
    for parser in (cli.build_parser(), parallel_cli.build_parser()):
        with pytest.raises(SystemExit):
            parser.parse_args(["--input", "x.raw", "--fast-math", "--exact-math"])
    assert "not allowed with" in capsys.readouterr().err


def run_cli(*args):
    """The port CLI on the demo, at two CPU threads (torch's default thread
    count beside other test workers slows it tenfold)."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    with open(DEMO, "rb") as fin:
        return subprocess.run([sys.executable, "-m", "msk144cudecoder_tpu_torch", *args],
                              stdin=fin, capture_output=True, text=True, cwd=ROOT, timeout=600,
                              env=env)


def test_fast_math_cli_prints_the_fp32_lines():
    """The port CLI on the demo with --fast-math prints the lines of the fp32
    run (but for date=), under the bf16 banner."""
    fp32 = run_cli("--device=cpu", *SMALL)
    fast = run_cli("--device=cpu", "--fast-math", *SMALL)
    for proc in (fp32, fast):
        assert proc.returncode == 0, proc.stderr[-3000:]

    def lines(out):
        return [re.sub(r"date=\d+;", "date=;", ln) for ln in out.splitlines()]

    assert lines(fast.stdout) == lines(fp32.stdout)
    assert "msg='CQ K1ABC FN42'" in fast.stdout
    assert "Precision: bf16 inputs, f32 accumulation" in fast.stderr
    assert "Precision: fp32" in fp32.stderr
