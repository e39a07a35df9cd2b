"""The root conftest's locked build of the native framer library: six
processes that build the same fresh copy of `native/` at once all load a
whole library, in each of three rounds (without the lock, a process could
open the file while another was still linking it)."""

import importlib.util
import os
import pathlib
import shutil
import subprocess
import sys
import time

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_PROCS = 6
ROUNDS = 3

# waits for the start file, builds the directory through the root conftest,
# then loads the library
CHILD = """
import ctypes, importlib.util, os, sys, time
root, native_dir, go = sys.argv[1:4]
spec = importlib.util.spec_from_file_location("root_conftest", os.path.join(root, "conftest.py"))
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
deadline = time.monotonic() + 60
while not os.path.exists(go) and time.monotonic() < deadline:
    time.sleep(0.001)
mod.build_native(native_dir)
ctypes.CDLL(os.path.join(native_dir, mod.LIBRARY))
print("loaded")
"""


def _root_conftest():
    spec = importlib.util.spec_from_file_location("root_conftest", ROOT / "conftest.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_concurrent_builds_of_a_fresh_native_dir_all_load(tmp_path):
    if not (shutil.which("make") and shutil.which(os.environ.get("CXX", "g++"))):
        pytest.skip("no native lib/toolchain")
    conftest = _root_conftest()
    native_dir = tmp_path / "native"
    native_dir.mkdir()
    for name in ("msk144_io.cpp", "Makefile"):
        shutil.copy(ROOT / "native" / name, native_dir / name)
    for r in range(ROUNDS):
        (native_dir / conftest.LIBRARY).unlink(missing_ok=True)
        go = tmp_path / f"go{r}"
        procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(ROOT), str(native_dir),
                                   str(go)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for _ in range(N_PROCS)]
        time.sleep(1.0)  # let every child reach its wait
        go.touch()
        outs = [p.communicate(timeout=180) for p in procs]
        assert [p.returncode for p in procs] == [0] * N_PROCS, (r, [e[-800:] for _, e in outs])
        assert all(out.strip() == "loaded" for out, _ in outs), r
