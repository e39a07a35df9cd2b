"""The PyTorch port's host runtime and CLI on the CPU: output lines
identical to the JAX CLI's on the demo capture, StreamDecoder's batching and
survivor-overflow warning, the import guard (the port never imports jax or
the JAX package), and no hidden fallback from CUDA to the CPU."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

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


def test_cli_lines_match_jax_cli(port_run):
    """The JAX CLI with the prefilter on takes the same path on the CPU (the
    jnp survivor demod behind prefilter_select)."""
    ref = run("msk144cudecoder_tpu", "--platform=cpu", "--survivor-prefilter=512", *SMALL)
    assert ref.returncode == 0, ref.stderr
    assert lines(port_run.stdout) == lines(ref.stdout)
    msgs = {ln.split("msg='")[1].split("'")[0] for ln in port_run.stdout.splitlines()
            if "msg='" in ln}
    assert msgs == {"CQ K1ABC FN42", "K1ABC W9XYZ EN37", "W9XYZ K1ABC RR73"}
    assert "Precision: fp32" in port_run.stderr and "Device: cpu" in port_run.stderr


def test_window_batch_mode_same_lines(port_run):
    proc = run("msk144cudecoder_tpu_torch", "--device=cpu", "--window-batch=8", *SMALL)
    assert proc.returncode == 0, proc.stderr
    assert lines(proc.stdout) == lines(port_run.stdout)


def test_no_hidden_fallback_without_cuda(tmp_path):
    """The default device is cuda: without one the CLI stops with a clear
    message instead of decoding on the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = run("msk144cudecoder_tpu_torch", *SMALL, env=env)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "--device=cpu" in proc.stderr
    assert "msg=" not in proc.stdout


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
            "import msk144cudecoder_tpu_torch.stimulus\n"
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
    many = StreamDecoder(cfg).decode_many(windows)
    one = StreamDecoder(cfg)
    single = [one.decode_block(w) for w in windows]
    key = [[(r.message, r.f0, r.num_avg, r.nbadsync, r.snr) for r in items] for items in many]
    assert key == [[(r.message, r.f0, r.num_avg, r.nbadsync, r.snr) for r in items]
                   for items in single]
    assert any(key)


def test_overflow_warning_says_at_least(busy_windows, capsys):
    cfg = DecoderConfig(search_width=64.0, scan_depth=6, nbadsync_threshold=3,
                        max_survivors=64, center_frequency=1450.0)
    dec = StreamDecoder(cfg)
    res = dec.decode_to_host(busy_windows[:2])
    dec.postprocess_batch(res, 2)
    err = capsys.readouterr().err
    n = int(res.num_survivors[0])
    assert n > 64
    assert f"Warning: at least {n} sync survivors exceed the LDPC batch (max_survivors=64)" in err
    assert err.count("Warning:") == 1  # the second window folds into the aggregate


def test_unpack_cache_is_bounded(monkeypatch):
    monkeypatch.setattr(decoder_mod, "DECODE_CACHE_MAX", 4)
    dec = StreamDecoder(DecoderConfig(search_width=32.0))
    rng = np.random.default_rng(0)
    for _ in range(10):
        dec._unpack_cached(rng.integers(0, 2, C.NUM_MESSAGE_BITS).astype(np.int8))
    assert len(dec._decode_cache) == 4
