"""ctypes bindings for the native C++ stream framer (native/msk144_io.cpp).

Port of msk144cudecoder_tpu/runtime/native.py, with its API. The shared
library is compiled from the repository's native/msk144_io.cpp with
`g++ -O2 -shared -fPIC` at first use, into the git-ignored ../_build/,
keyed on a hash of the source and the flags (as ops/kernels.py keys the
CUDA library); nothing is written into native/. Everything here has a
numpy fallback (runtime/stream.py), so the decoder also runs without a
compiler; `available()` says which path is active.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import sys
import threading
from typing import BinaryIO, Iterator, Optional

import numpy as np

from .. import constants as C
from .metrics import ScopedMetric

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR.parent / "native" / "msk144_io.cpp"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmsk144_io_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the framer into its hashed library unless it exists. Raises
    when the source or g++ is missing or the compile fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found: the native framer is built at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SOURCE.name} ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def _load() -> Optional[ctypes.CDLL]:
    """The framer library, built and loaded once per process; None when it
    cannot be (no source, no g++, a failed compile)."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError):
            return None
        lib.msk144_framer_create.restype = ctypes.c_void_p
        lib.msk144_framer_create.argtypes = [ctypes.c_int]
        lib.msk144_framer_destroy.restype = None
        lib.msk144_framer_destroy.argtypes = [ctypes.c_void_p]
        lib.msk144_framer_push.restype = ctypes.c_int
        lib.msk144_framer_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
        lib.msk144_framer_pop.restype = ctypes.c_int
        lib.msk144_framer_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.msk144_framer_windows_emitted.restype = ctypes.c_longlong
        lib.msk144_framer_windows_emitted.argtypes = [ctypes.c_void_p]
        lib.msk144_framer_pending_bytes.restype = ctypes.c_longlong
        lib.msk144_framer_pending_bytes.argtypes = [ctypes.c_void_p]
        lib.msk144_convert_int16_rms.restype = ctypes.c_float
        lib.msk144_convert_int16_rms.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        lib.msk144_convert_iq8.restype = None
        lib.msk144_convert_iq8.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native msk144_io library unavailable")
    return lib


class NativeFramer:
    """50%-overlap window framer backed by the C++ ring buffer."""

    def __init__(self, read_mode: int):
        lib = _require()
        self._lib = lib
        self._h = lib.msk144_framer_create(read_mode)
        if not self._h:
            raise ValueError(f"bad read_mode {read_mode}")
        self._dtype = np.int8 if read_mode == 2 else np.int16
        self._items = C.WINDOW_LEN * (2 if read_mode == 2 else 1)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.msk144_framer_destroy(h)
            self._h = None

    def push(self, data: bytes) -> int:
        """Feed raw stream bytes; returns complete windows now available."""
        return self._lib.msk144_framer_push(self._h, data, len(data))

    def pop(self) -> Optional[np.ndarray]:
        """Next raw window (int16 (5184,) or int8 (10368,)) or None."""
        out = np.empty(self._items, dtype=self._dtype)
        ok = self._lib.msk144_framer_pop(self._h, out.ctypes.data_as(ctypes.c_void_p))
        return out if ok else None

    @property
    def windows_emitted(self) -> int:
        return int(self._lib.msk144_framer_windows_emitted(self._h))

    @property
    def pending_bytes(self) -> int:
        return int(self._lib.msk144_framer_pending_bytes(self._h))


def convert_int16_rms(samples: np.ndarray) -> tuple[np.ndarray, float]:
    """Native int16 -> float32 / rms conversion (the reference's audio
    normalisation)."""
    lib = _require()
    samples = np.ascontiguousarray(samples, dtype=np.int16)
    out = np.empty(len(samples), dtype=np.float32)
    rms = lib.msk144_convert_int16_rms(samples.ctypes.data_as(ctypes.c_void_p),
                                       out.ctypes.data_as(ctypes.c_void_p), len(samples))
    return out, float(rms)


def convert_iq8(samples: np.ndarray) -> np.ndarray:
    """Native int8 IQ -> float32 interleaved, scaled 1/128."""
    lib = _require()
    samples = np.ascontiguousarray(samples, dtype=np.int8)
    out = np.empty(len(samples), dtype=np.float32)
    lib.msk144_convert_iq8(samples.ctypes.data_as(ctypes.c_void_p),
                           out.ctypes.data_as(ctypes.c_void_p), len(samples))
    return out


def native_window_stream(fp: BinaryIO, read_mode: int,
                         chunk_bytes: int = 1 << 16) -> Iterator[np.ndarray]:
    """runtime.stream.window_stream driven by the native framer: the same
    windows, and the same short-read message at the end of the stream. Each
    window is a `frame` span (its pop, and the reads and pushes it needed)."""
    framer = NativeFramer(read_mode)
    item = 1 if read_mode == 2 else 2
    while True:
        with ScopedMetric("frame"):
            w = _next_window(framer, fp, chunk_bytes)
        if w is None:
            # EOF: report the unframed remainder like the reference's short read
            print(f"Incomplete read error. rc={framer.pending_bytes // item}", file=sys.stderr)
            return
        yield w


def _next_window(framer: NativeFramer, fp: BinaryIO, chunk_bytes: int) -> Optional[np.ndarray]:
    """The framer's next window, reading and pushing chunks of fp until it
    has one; None at the end of the stream."""
    while (w := framer.pop()) is None:
        data = fp.read(chunk_bytes)
        if not data:
            return None
        framer.push(data)
    return w
