"""The PyTorch port's host runtime and CLI on the CPU: the pipelined
throughput mode (--window-batch with --pipeline-depth) against the
sequential mode and the JAX CLI, --profile-dir, StreamDecoder's batching,
its thread-safe decode_to_host and survivor-overflow warning ("at least"
only with the prefilter on), the busy band on the full demod, the import
guard (the port never imports jax or the JAX package), the kernel
library's one build under concurrent first calls, and no hidden fallback
from CUDA to the CPU. Its lines against the JAX CLI's on the demo are in
tests/test_torch_cli_jax_lines.py and tests/test_torch_cli_jax_full_demod.py."""

import json
import os
import pathlib
import re
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from msk144cudecoder_tpu import golden as G
from msk144cudecoder_tpu_torch import constants as C
from msk144cudecoder_tpu_torch import stimulus
from msk144cudecoder_tpu_torch.config import DecoderConfig
from msk144cudecoder_tpu_torch.ops import kernels
from msk144cudecoder_tpu_torch.runtime import StreamDecoder
from msk144cudecoder_tpu_torch.runtime import decoder as decoder_mod

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
DEMO = ROOT / "demo" / "capture.raw"
PORT = ROOT / "msk144cudecoder_tpu_torch"
SMALL = ["--search-width=100", "--scan-depth=4"]


def run(module, *args, stdin_path=DEMO, env=None):
    with open(stdin_path, "rb") as fin:
        return subprocess.run([sys.executable, "-m", module, *args], stdin=fin,
                              capture_output=True, text=True, cwd=ROOT, timeout=600,
                              env=env)


def lines(stdout: str) -> list[str]:
    return [re.sub(r"date=\d+;", "date=;", ln) for ln in stdout.splitlines()]


@pytest.fixture(scope="module")
def port_run():
    proc = run("msk144cudecoder_tpu_torch", "--device=cpu", *SMALL)
    assert proc.returncode == 0, proc.stderr
    return proc


def test_window_batch_mode_same_lines(port_run):
    proc = run("msk144cudecoder_tpu_torch", "--device=cpu", "--window-batch=8", *SMALL)
    assert proc.returncode == 0, proc.stderr
    assert lines(proc.stdout) == lines(port_run.stdout)


def staggered_stream(path: pathlib.Path) -> pathlib.Path:
    """tests/test_runtime.py's staggered stream: two pings overlapping in
    time, three windows (one batch of 2 and a zero-padded tail of 1)."""
    rng = np.random.default_rng(77)
    n = 12 * C.FRAME_LEN
    t = np.arange(n)
    sig = np.zeros(n, dtype=np.complex128)
    for text, f0, snr, s in [("CQ K1ABC FN42", 1470.0, 7.0, 0),
                             ("K1ABC W9XYZ EN37", 1530.0, 5.0, 4)]:
        bb = np.tile(G.modulate_frame(G.frame_bits_from_message(text)), 5)
        amp = np.sqrt(2.0 * 10 ** (snr / 10.0))
        lo, hi = s * C.FRAME_LEN, (s + 5) * C.FRAME_LEN
        sig[lo:hi] += amp * bb * np.exp(2j * np.pi * f0 * t[lo:hi] / C.SAMPLE_RATE)
    noise = np.sqrt(0.5 * (C.SAMPLE_RATE / 2) / 2500.0) * np.sqrt(2.0)
    sig += noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    path.write_bytes(np.clip(np.round(sig.real * 1000.0), -32768, 32767)
                     .astype(np.int16).tobytes())
    return path


def test_throughput_mode_matches_sequential_and_jax(tmp_path):
    """--window-batch 2 --pipeline-depth 2 prints the sequential mode's lines
    and the JAX CLI's with the same flags (both with the prefilter at 512
    rows, the port's default path), in stream order through the padded
    tail, and the steady-state Throughput line."""
    stream = staggered_stream(tmp_path / "staggered.raw")
    flags = ["--search-width", "200", "--scan-depth", "3", "--survivor-prefilter=512"]
    batch = ["--window-batch", "2", "--pipeline-depth", "2"]
    seq = run("msk144cudecoder_tpu_torch", "--device=cpu", *flags, stdin_path=stream)
    bat = run("msk144cudecoder_tpu_torch", "--device=cpu", *flags, *batch, stdin_path=stream)
    ref = run("msk144cudecoder_tpu", "--platform=cpu", *flags, *batch, stdin_path=stream)
    for proc in (seq, bat, ref):
        assert proc.returncode == 0, proc.stderr[-3000:]
    assert lines(bat.stdout) == lines(seq.stdout) == lines(ref.stdout)
    assert "msg='CQ K1ABC FN42'" in bat.stdout and "msg='K1ABC W9XYZ EN37'" in bat.stdout
    assert bat.stdout.strip().endswith("Done")
    assert re.search(r"Throughput: 1 windows in [0-9.]+ s = [0-9.]+ ms/window "
                     r"\([0-9.,]+x real time, steady-state after first batch\)", bat.stderr)


def test_profile_dir_writes_trace(tmp_path):
    prof = tmp_path / "prof"
    proc = run("msk144cudecoder_tpu_torch", "--device=cpu", *SMALL, "--window-batch=8",
               "--pipeline-depth=2", f"--profile-dir={prof}")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"Profiler trace written to {prof}" in proc.stderr
    trace = json.loads((prof / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)  # the worker threads' ops


def test_decode_to_host_from_threads(busy_windows):
    """Four threads decoding different batches at once give each batch's
    sequential result, leaf for leaf."""
    cfg = DecoderConfig(search_width=64.0, scan_depth=6, nbadsync_threshold=3,
                        max_survivors=128, center_frequency=1450.0)
    dec = StreamDecoder(cfg, "cpu")
    batches = [busy_windows[i:i + 2] for i in range(4)]
    want = [dec.decode_to_host(b) for b in batches]
    with ThreadPoolExecutor(max_workers=4) as pool:
        got = list(pool.map(dec.decode_to_host, batches))
    for w, g in zip(want, got):
        for f in w._fields:
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f), err_msg=f)


def test_kernel_library_builds_once_under_threads(monkeypatch, tmp_path):
    """Four threads that make the first kernel call together build the
    library once and share it."""
    builds = []

    def slow_build():
        builds.append(threading.get_ident())
        time.sleep(0.2)
        return tmp_path / "libfake.so"

    class FakeLib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(kernels, "build", slow_build)
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda path: FakeLib())
    with ThreadPoolExecutor(max_workers=4) as pool:
        libs = list(pool.map(lambda _: kernels.library(), range(4)))
    assert len(builds) == 1
    assert all(lib is libs[0] for lib in libs)


def test_launch_counts_survive_threads(monkeypatch):
    from msk144cudecoder_tpu_torch.ops import scan

    monkeypatch.setattr(scan.scan_cuda, "launches", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=16) as pool:
            list(pool.map(lambda _: [kernels.count_launch(scan.scan_cuda) for _ in range(500)],
                          range(16)))
    finally:
        sys.setswitchinterval(interval)
    assert kernels.launch_counts()["scan"] == 16 * 500


def test_no_hidden_fallback_without_cuda(tmp_path):
    """The default device is cuda: without one the CLI stops with a clear
    message instead of decoding on the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = run("msk144cudecoder_tpu_torch", *SMALL, env=env)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "--device=cpu" in proc.stderr
    assert "msg=" not in proc.stdout


def _entry_points():
    """Each entry point that decodes on a device, called with `device`
    (None: its default)."""
    from msk144cudecoder_tpu_torch.ops import pipeline
    from msk144cudecoder_tpu_torch.parallel import make_mesh, multihost

    cfg = DecoderConfig(search_width=16.0, scan_depth=1)
    raw = np.zeros((1, C.WINDOW_LEN), np.int16)
    return {
        "StreamDecoder": lambda d: StreamDecoder(cfg) if d is None else StreamDecoder(cfg, d),
        "decode_raw": lambda d: pipeline.decode_raw(raw, cfg, d),
        "make_mesh": lambda d: make_mesh(1, None, None if d is None else [d, d]),
        "local_devices": lambda d: multihost.local_devices(d),
    }


@pytest.mark.parametrize("entry", ["StreamDecoder", "decode_raw", "make_mesh", "local_devices"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """Without a card each entry point raises by default and for "cuda", and
    runs on the CPU only when asked for "cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = _entry_points()[entry]
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(device)
    assert call("cpu") is not None


def test_kernel_library_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.library()


def test_import_guard():
    """Importing the port pulls in neither jax nor the JAX package, and no
    file of the port imports jax."""
    code = ("import sys\n"
            "import msk144cudecoder_tpu_torch, msk144cudecoder_tpu_torch.cli\n"
            "import msk144cudecoder_tpu_torch.ops.pipeline, msk144cudecoder_tpu_torch.runtime\n"
            "import msk144cudecoder_tpu_torch.stimulus, msk144cudecoder_tpu_torch.runtime.native\n"
            "import msk144cudecoder_tpu_torch.parallel, msk144cudecoder_tpu_torch.parallel.cli\n"
            "import msk144cudecoder_tpu_torch.runtime.evidence\n"
            "import msk144cudecoder_tpu_torch.tools.sensitivity_sweep\n"
            "import msk144cudecoder_tpu_torch.tools.run_hwtests\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'msk144cudecoder_tpu' or m.startswith('msk144cudecoder_tpu.')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    for path in PORT.rglob("*.py"):
        text = path.read_text()
        assert not re.search(r"^\s*(import jax|from jax)", text, re.M), path
        assert not re.search(r"^\s*(import|from) msk144cudecoder_tpu\b(?!_torch)", text,
                             re.M), path


@pytest.fixture(scope="module")
def busy_windows():
    return stimulus.stream_windows(stimulus.busy_band_audio())


def test_decode_many_equals_decode_block(busy_windows):
    cfg = DecoderConfig(search_width=64.0, scan_depth=6, nbadsync_threshold=3,
                        max_survivors=128, center_frequency=1450.0)
    windows = busy_windows[:4]
    many = StreamDecoder(cfg, "cpu").decode_many(windows)
    one = StreamDecoder(cfg, "cpu")
    single = [one.decode_block(w) for w in windows]
    key = [[(r.message, r.f0, r.num_avg, r.nbadsync, r.snr) for r in items] for items in many]
    assert key == [[(r.message, r.f0, r.num_avg, r.nbadsync, r.snr) for r in items]
                   for items in single]
    assert any(key)


def test_overflow_warning_says_at_least(busy_windows, capsys):
    cfg = DecoderConfig(search_width=64.0, scan_depth=6, nbadsync_threshold=3,
                        max_survivors=64, center_frequency=1450.0)
    dec = StreamDecoder(cfg, "cpu")
    res = dec.decode_to_host(busy_windows[:2])
    dec.postprocess_batch(res, 2)
    err = capsys.readouterr().err
    n = int(res.num_survivors[0])
    assert n > 64
    assert f"Warning: at least {n} sync survivors exceed the LDPC batch (max_survivors=64)" in err
    assert err.count("Warning:") == 1  # the second window folds into the aggregate


def test_overflow_warning_exact_without_prefilter(busy_windows, capsys):
    """With the prefilter off every candidate is demodulated, so the count
    is exact and the warning prints it without "at least"."""
    cfg = DecoderConfig(search_width=64.0, scan_depth=6, nbadsync_threshold=3,
                        max_survivors=64, center_frequency=1450.0, survivor_prefilter=0)
    dec = StreamDecoder(cfg, "cpu")
    res = dec.decode_to_host(busy_windows[:2])
    dec.postprocess_batch(res, 2)
    err = capsys.readouterr().err
    n = int(res.num_survivors[0])
    assert n > 64
    assert f"Warning: {n} sync survivors exceed the LDPC batch (max_survivors=64)" in err
    assert "at least" not in err


def test_busy_band_full_demod(busy_windows):
    """The busy band at prefilter 0 and K = every candidate (4848), the
    tests/test_busyband.py full run: each of the four pings decodes with
    (num_avg, nbadsync) = (1, 0) within one step of its planted frequency."""
    cfg = DecoderConfig(search_width=200.0, search_step=2.0, scan_depth=6,
                        nbadsync_threshold=3, survivor_prefilter=0, max_survivors=4848)
    assert cfg.num_candidates == 4848
    dec = StreamDecoder(cfg, "cpu")
    best = {}
    for lo in range(0, len(busy_windows), 2):  # two windows per call bound the memory
        for items in dec.decode_many(busy_windows[lo:lo + 2]):
            for r in items:
                if r.message not in best or (r.num_avg, r.nbadsync) < best[r.message][:2]:
                    best[r.message] = (r.num_avg, r.nbadsync, r.f0)
    assert set(best) == {p[0] for p in stimulus.BUSY_BAND_PINGS}
    for text, f0, *_ in stimulus.BUSY_BAND_PINGS:
        assert best[text][:2] == (1, 0), (text, best[text])
        assert abs(best[text][2] - f0) <= cfg.search_step, (text, best[text])


def test_unpack_cache_is_bounded(monkeypatch):
    monkeypatch.setattr(decoder_mod, "DECODE_CACHE_MAX", 4)
    dec = StreamDecoder(DecoderConfig(search_width=32.0), "cpu")
    rng = np.random.default_rng(0)
    for _ in range(10):
        dec._lookup(np.packbits(rng.integers(0, 2, C.NUM_MESSAGE_BITS)).tobytes())
    assert len(dec._decode_cache) == 4
