"""The PyTorch port's CLI on the CPU against the JAX CLI on the demo
capture, with the prefilter on (the port's default path): the same output
lines. Its own file, apart from tests/test_torch_cli.py, so that the
test workers run it beside the others."""

import pathlib
import re
import subprocess
import sys

import pytest
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
