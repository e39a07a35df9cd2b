"""Build, binding and launch accounting for the hand-written CUDA kernels.

The sources under ../csrc/ compile with nvcc into ONE shared library with a
plain C interface, loaded with ctypes (no PyTorch headers, so a build takes
seconds). The library is keyed on a hash of the sources and the flags and
lives in ../_build/ (git-ignored); the first kernel call builds it. Nothing
here runs at import time: the CPU test suite imports every module on a
machine without nvcc or a GPU.

Each C entry point launches one kernel on the stream it is given and
returns cudaGetLastError(); raise_on_error turns a nonzero code into an
exception. Launch counts live on the wrappers (scan.scan_cuda.launches,
survivor.demod_survivors_cuda.launches, ldpc.bp_decode_cuda.launches);
launch_counts / reset_launch_counts read and clear all three.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {
    # c, B, E_dec, chi, pos_out, xb_out, n_win, F, depth, num_cand, dec, stream
    "msk_scan": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # c, W, chi, pos, f_idx, p_idx, sync_conj, pp12, masks, sync_pm, sb_out,
    # nbad_out, n_win, S, F, stream
    "msk_survivor": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # llr, valid, nm, mn_edge, crc, cw_out, found_out, iters_out, nerr_out,
    # rows, max_iters, stream
    "msk_bp": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
}

_lib = None  # the loaded library, once built
last_build_seconds = None  # wall time of this process's nvcc run, if any


def sources() -> list[pathlib.Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_DIR / f"libmsk144_kernels_{source_hash()}.so"


def find_nvcc() -> str:
    """$CUDA_HOME/bin/nvcc (CUDA_HOME defaults to /usr/local/cuda), else the
    nvcc on PATH."""
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
             shutil.which("nvcc")]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels are built from csrc/ at first use")


def build() -> pathlib.Path:
    """Compile csrc/*.cu into the hashed library unless it already exists.
    ptxas's per-kernel register/shared-memory report goes to <lib>.log."""
    global last_build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-Xptxas=-v", "-o", str(tmp),
           *[str(p) for p in sorted(CSRC_DIR.glob("*.cu"))]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    last_build_seconds = time.perf_counter() - t0
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The kernel library, built on first use. Raises if it cannot be built
    or loaded: a CUDA tensor never falls back to the plain path."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.msk_error_string.argtypes = (ctypes.c_int,)
        lib.msk_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def raise_on_error(name: str, rc: int) -> None:
    if rc != 0:
        msg = library().msk_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def on_cuda(t: torch.Tensor) -> bool:
    """Dispatch rule of the public ops: True for a CUDA tensor, False for a
    CPU tensor; any other device raises."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}: use cuda or cpu")


def check_tensors(op: str, **specs) -> None:
    """specs: name=(tensor, dtype, shape) with -1 for a free dimension.
    Every tensor must be contiguous, of that dtype and shape, and on the
    same CUDA device as the first."""
    dev = None
    for name, (t, dtype, shape) in specs.items():
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"{op}: {name} must be a CUDA tensor")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{op}: {name} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{op}: {name} has dtype {t.dtype}, expected {dtype}")
        if t.dim() != len(shape) or any(s not in (-1, d) for s, d in zip(shape, t.shape)):
            raise ValueError(f"{op}: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")


def launch_counts() -> dict[str, int]:
    from . import ldpc, scan, survivor

    return {"scan": scan.scan_cuda.launches,
            "survivor": survivor.demod_survivors_cuda.launches,
            "bp": ldpc.bp_decode_cuda.launches}


def reset_launch_counts() -> None:
    from . import ldpc, scan, survivor

    scan.scan_cuda.launches = 0
    survivor.demod_survivors_cuda.launches = 0
    ldpc.bp_decode_cuda.launches = 0
