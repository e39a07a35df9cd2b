"""Repository-wide pytest set-up: build the native framer library once,
under a file lock, before any test module is imported.

The JAX package's loader (`msk144cudecoder_tpu/runtime/native.py` `_load`)
runs `make -C native` when `native/libmsk144_io.so` is missing, and the
Makefile links straight into its target. Under pytest-xdist every worker
imports that module while it collects, so a worker could open the library
while another was still writing it, get OSError, and skip the native tests.
pytest loads this file in the controller and in every worker before
collection; building here, one process at a time, leaves a whole library for
every later import.

This file imports nothing of the JAX package: its `runtime` package imports
jax before `tests/conftest.py` has set the platform and XLA_FLAGS.
"""

from __future__ import annotations

import fcntl
import hashlib
import pathlib
import subprocess
import tempfile

NATIVE_DIR = pathlib.Path(__file__).resolve().parent / "native"
LIBRARY = "libmsk144_io.so"


def build_native(native_dir) -> None:
    """Run the JAX loader's `make -C native_dir` where the library is
    missing, holding an exclusive lock on a file outside native_dir (one per
    directory, in the temporary directory) over the check and the build: a
    concurrent caller waits, then finds the whole file. A failed build is
    left to the loader, so without make or g++ the native tests skip as
    before."""
    native_dir = pathlib.Path(native_dir).resolve()
    tag = hashlib.sha1(str(native_dir).encode()).hexdigest()[:16]
    lock = pathlib.Path(tempfile.gettempdir()) / f"msk144-native-build-{tag}.lock"
    with open(lock, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        if (native_dir / LIBRARY).exists():
            return
        try:
            subprocess.run(["make", "-C", str(native_dir)], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            pass


def pytest_configure(config) -> None:
    build_native(NATIVE_DIR)
