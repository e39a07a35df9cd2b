"""The streaming soak through the PyTorch port's CLI on the CPU: the scene of
tests/test_soak.py (110 windows, ~24 s, three bursts at varying SNR and
frequency, one straddling a window boundary), made by the port's own
stimulus, piped through `python -m msk144cudecoder_tpu_torch --device=cpu`.

The asserts of tests/test_soak.py: every burst decodes and nothing else,
1-8 lines per text (dedup holds per window), every f0 within 2 Hz, and the
stream ends cleanly ("Done", the reference's short-read message). The
port's CPU path takes seconds here, so the test is not marked slow."""

import os
import pathlib
import re
import subprocess
import sys

from msk144cudecoder_tpu_torch import stimulus

ROOT = pathlib.Path(__file__).resolve().parents[1]
FLAGS = ["--search-width", "100", "--scan-depth", "6", "--nbadsync-threshold", "2"]


def test_streaming_soak_cpu():
    # two threads: torch's default of one per core slows the decode many
    # times over when other test processes share the cores
    proc = subprocess.run(
        [sys.executable, "-m", "msk144cudecoder_tpu_torch", "--device=cpu", *FLAGS],
        input=stimulus.soak_audio(1234).tobytes(), capture_output=True, cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="2"), timeout=600)
    out, err = proc.stdout.decode(), proc.stderr.decode()
    assert proc.returncode == 0, err[-3000:]
    assert out.rstrip().endswith("Done")
    lines = [ln for ln in out.splitlines() if ln.startswith("*** ")]
    texts = [re.search(r"msg='([^']*)'", ln).group(1) for ln in lines]
    f0s = [float(re.search(r"f0=\s*([0-9.]+)", ln).group(1)) for ln in lines]

    assert set(texts) == {b[0] for b in stimulus.SOAK_BURSTS}, (sorted(set(texts)), out[-2000:])
    for text, f0, *_ in stimulus.SOAK_BURSTS:
        assert 1 <= texts.count(text) <= 8, (text, texts.count(text))
        for got_f0, got_text in zip(f0s, texts):
            if got_text == text:
                assert abs(got_f0 - f0) <= 2.0, (text, got_f0)
    assert "Incomplete read error" in err
