"""Provenance stamping for committed GPU evidence.

The on-card battery (tools/run_hwtests.py of this package) pins its result
as tests/data/hwtests_gpu.json. That record is evidence only for the code
that produced it: a kernel edit without a new run on the card would
otherwise still read as validated. The record therefore carries a
`provenance` stamp, the git revision and a content hash of the compute
path, and the CPU suite (tests/test_torch_hw.py) fails when the pinned hash
no longer matches the tree. The same stamp as the JAX package's
(msk144cudecoder_tpu/runtime/evidence.py), over this package's sources.
"""

from __future__ import annotations

import hashlib
import pathlib
import subprocess

_PKG = pathlib.Path(__file__).resolve().parents[1]
_REPO = _PKG.parent

#: compute-path sources whose edits invalidate pinned GPU evidence: every
#: pipeline and kernel-wrapper file, the CUDA kernels themselves, the
#: sharded formulations they run under, and the files that fix
#: decode-affecting defaults and protocol constants. Paths are relative to
#: the package, so a copy of it (a `git archive`) hashes the same.
_HASHED = ("ops/*.py", "parallel/sharding.py", "parallel/multihost.py",
           "config.py", "constants.py", "csrc/*.cu", "csrc/*.cuh")


def ops_content_hash(pkg: pathlib.Path = _PKG) -> str:
    """sha256 over the compute-path sources of the package at `pkg` (sorted
    relative paths, contents)."""
    h = hashlib.sha256()
    files: list[pathlib.Path] = []
    for pat in _HASHED:
        files.extend(pkg.glob(pat))
    for f in sorted(files, key=lambda f: f.relative_to(pkg).as_posix()):
        h.update(f.relative_to(pkg).as_posix().encode())
        h.update(b"\0")
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def git_revision() -> tuple[str, bool]:
    """(short sha, dirty?) of the repo, or ("unknown", False) outside git."""
    try:
        sha = subprocess.run(
            ["git", "-C", str(_REPO), "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10).stdout.strip()
        dirty = bool(subprocess.run(
            ["git", "-C", str(_REPO), "status", "--porcelain",
             "--untracked-files=no"],
            capture_output=True, text=True, timeout=10).stdout.strip())
        return (sha or "unknown", dirty)
    except (OSError, subprocess.SubprocessError):
        return ("unknown", False)


def provenance() -> dict:
    """Stamp for evidence JSONs: {git_sha, git_dirty, ops_hash}."""
    sha, dirty = git_revision()
    return {"git_sha": sha, "git_dirty": dirty, "ops_hash": ops_content_hash()}
