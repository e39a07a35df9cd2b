"""The PyTorch port's pinned GPU evidence, checked on the CPU.

`python -m msk144cudecoder_tpu_torch.tools.run_hwtests` runs the on-card
battery on the H100 and writes tests/data/hwtests_gpu.json. These tests
fail when that record is not a passing run on an H100, or when its ops_hash
is not the hash of this tree's compute path (runtime/evidence.py): after an
edit to a hashed file (ops/*.py, csrc/*.cu, csrc/*.cuh, parallel/sharding.py,
parallel/multihost.py, config.py, constants.py), re-run the battery on the
H100 and commit the JSON it prints. With MSK144_GPU_HWTESTS=1 (on a machine
with a card) the battery itself runs here, in a subprocess, as
tests/test_hw.py runs the JAX package's."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from msk144cudecoder_tpu_torch.runtime import evidence

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "msk144cudecoder_tpu_torch"
EVIDENCE = REPO / "tests" / "data" / "hwtests_gpu.json"
STEPS = ("gpu_tests", "kernels", "busyband", "cli", "mesh", "inputs", "sensitivity", "soak",
         "precision", "graph")
REPIN = ("re-run `python -m msk144cudecoder_tpu_torch.tools.run_hwtests` on the H100 and "
         "commit tests/data/hwtests_gpu.json")


@pytest.mark.skipif(not os.environ.get("MSK144_GPU_HWTESTS"),
                    reason="set MSK144_GPU_HWTESTS=1 to run the battery on the card")
def test_gpu_validation_battery():
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    proc = subprocess.run([sys.executable, "-m", "msk144cudecoder_tpu_torch.tools.run_hwtests"],
                          cwd=REPO, env=env, timeout=3600)
    assert proc.returncode == 0, "run_hwtests failed (see its output above)"


def test_battery_without_a_card_exits_1(monkeypatch, capsys):
    """No card: exit 1, no record written, nothing on stdout; and the
    battery runs the steps these tests hold the record to."""
    import torch

    from msk144cudecoder_tpu_torch.tools import run_hwtests

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = EVIDENCE.read_bytes() if EVIDENCE.exists() else None
    assert run_hwtests.main() == 1
    assert capsys.readouterr().out == ""
    assert (EVIDENCE.read_bytes() if EVIDENCE.exists() else None) == before
    assert tuple(name for name, _ in run_hwtests.STEPS) == STEPS


def test_battery_refuses_optimized_python():
    """Under -O its asserts, which are its checks, would be gone: it must
    not run, so it cannot pin a record that checked nothing."""
    proc = subprocess.run(
        [sys.executable, "-O", "-m", "msk144cudecoder_tpu_torch.tools.run_hwtests"],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 1 and proc.stdout == "", proc
    assert "without -O" in proc.stderr, proc.stderr


def pinned() -> dict:
    assert EVIDENCE.exists(), f"no pinned GPU evidence: {REPIN}"
    return json.loads(EVIDENCE.read_text())


def test_pinned_evidence_is_green():
    """A failed battery pinned into tests/data/ would otherwise read as
    validation on the card."""
    rec = pinned()
    assert rec["ok"], rec
    assert "H100" in rec["device"] and "H100" in rec["card"], (rec["device"], rec["card"])
    assert rec["card"].rstrip().endswith("W"), rec["card"]  # name, power limit
    for key in ("torch", "cuda", "nvcc"):
        assert rec[key], key
    for step in STEPS:
        assert rec["steps"][step]["ok"], (step, rec["steps"][step])
    from msk144cudecoder_tpu_torch.tools.run_hwtests import GPU_TESTS_MIN

    gpu = rec["steps"]["gpu_tests"]
    assert gpu["failed"] == 0 and gpu["skipped"] == 0 and gpu["passed"] >= GPU_TESTS_MIN, gpu
    sens = rec["steps"]["sensitivity"]
    assert sens["protocol"]["search_width"] == 500.0 and sens["protocol"]["trials"] == 20
    # the card against the CPU, and the bf16 mode against float32 on the card
    for differ in (sens["differ"], rec["steps"]["precision"]["sweep_differ"]):
        for snr, diff in differ.items():
            assert len(diff) <= (0 if float(snr) >= -6.0 else 1), (snr, diff)


def test_pinned_evidence_matches_the_tree():
    """Provenance binding: the record carries the compute-path hash of the
    tree that produced it."""
    prov = pinned().get("provenance")
    assert prov, f"the pinned record has no provenance stamp: {REPIN}"
    current = evidence.ops_content_hash()
    assert prov["ops_hash"] == current, (
        f"tests/data/hwtests_gpu.json was produced by ops revision {prov['ops_hash']} (git "
        f"{prov['git_sha']}) but the tree is {current}: the GPU evidence is stale; {REPIN}")


@pytest.fixture()
def package_copy(tmp_path):
    dst = tmp_path / "msk144cudecoder_tpu_torch"
    shutil.copytree(PORT, dst, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    return dst


@pytest.mark.parametrize("rel,hashed", [
    ("csrc/scan.cu", True),
    ("csrc/common.cuh", True),
    ("ops/pipeline.py", True),
    ("parallel/sharding.py", True),
    ("config.py", True),
    ("runtime/decoder.py", False),
    ("tools/run_hwtests.py", False),
])
def test_hash_follows_the_compute_path(package_copy, rel, hashed):
    """A copy of the package hashes as the package does; one changed byte
    of a hashed file changes the hash, of any other file does not."""
    before = evidence.ops_content_hash(package_copy)
    assert before == evidence.ops_content_hash()
    path = package_copy / rel
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0x01
    path.write_bytes(bytes(data))
    assert (evidence.ops_content_hash(package_copy) != before) == hashed


def test_provenance_outside_git(package_copy, monkeypatch):
    """Without a git repository (a `git archive` copy) the revision is
    unknown and the stamp still carries the hash."""
    monkeypatch.setattr(evidence, "_REPO", package_copy.parent)
    monkeypatch.setenv("GIT_CEILING_DIRECTORIES", str(package_copy.parent.parent))
    assert evidence.git_revision() == ("unknown", False)
    assert evidence.provenance()["ops_hash"] == evidence.ops_content_hash()
