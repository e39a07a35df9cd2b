"""The PyTorch port's CLI on the CPU with the prefilter off (the full demod)
against the JAX CLI's default on the demo capture: the same output lines.
Its own file, apart from tests/test_torch_cli.py, so that the test
workers run it beside the others."""

import pathlib
import re
import subprocess
import sys

import torch

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
DEMO = ROOT / "demo" / "capture.raw"
SMALL = ["--search-width=100", "--scan-depth=4"]


def run(module, *args):
    with open(DEMO, "rb") as fin:
        return subprocess.run([sys.executable, "-m", module, *args], stdin=fin,
                              capture_output=True, text=True, cwd=ROOT, timeout=600)


def lines(stdout: str) -> list[str]:
    return [re.sub(r"date=\d+;", "date=;", ln) for ln in stdout.splitlines()]


def test_full_demod_cli_lines_match_jax_cli_default():
    """--survivor-prefilter=0 against the JAX CLI's default on the CPU, which
    resolves the prefilter to off there (the jnp full demod)."""
    ours = run("msk144cudecoder_tpu_torch", "--device=cpu", "--survivor-prefilter=0", *SMALL)
    assert ours.returncode == 0, ours.stderr
    ref = run("msk144cudecoder_tpu", "--platform=cpu", *SMALL)
    assert ref.returncode == 0, ref.stderr
    assert lines(ours.stdout) == lines(ref.stdout)
    msgs = {ln.split("msg='")[1].split("'")[0] for ln in ours.stdout.splitlines()
            if "msg='" in ln}
    assert msgs == {"CQ K1ABC FN42", "K1ABC W9XYZ EN37", "W9XYZ K1ABC RR73"}
