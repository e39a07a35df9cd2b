"""Build, binding and launch accounting for the hand-written CUDA kernels.

The sources under ../csrc/ compile with nvcc, one process per source, all
started together, and link into ONE shared library with a plain C
interface, loaded with ctypes (no PyTorch headers, so a build takes
seconds). The library is keyed on a hash of the sources and the flags and
lives in ../_build/ (git-ignored); the first kernel call builds it. Nothing
here runs at import time: the CPU test suite imports every module on a
machine without nvcc or a GPU.

Each C entry point launches one kernel on the stream it is given and
returns cudaGetLastError(); raise_on_error turns a nonzero code into an
exception. Every kernel has two instantiations in the library, float32 and
the bf16 fast_math policy (ops/precision.py), chosen by the entry point's
`fast` argument. Launch counts live on the wrappers (scan.scan_cuda,
survivor.demod_survivors_cuda, demod.demod_candidates_cuda,
ldpc.bp_decode_cuda), `launches` for float32 and `launches_fast` for fast;
count_launch adds to one, launch_counts / reset_launch_counts read and clear
all eight (the fast ones under "<kernel>_fast"). A CUDA graph capture
(ops/graphs.py) launches nothing: under `recording()` the wrappers' counts
go to the capture's tally instead, and each replay adds the tally
(add_launches), so that the counts stay the kernels' launches.

Several threads may decode at once (the CLI's throughput mode runs its
device calls on a worker pool): the first call builds the library under a
lock, temporary build files carry the process and thread id, and the
launch counts change under a lock.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {
    # c, B, E_dec, chi, pos_out, xb_out, n_win, F, depth, num_cand, dec,
    # freq_tile, fast, stream
    "msk_scan": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # c, W, chi, pos, f_idx, p_idx, sync_conj, pp12, masks, sync_pm, sb_out,
    # nbad_out, n_win, S, F, rows_per_block, fast, stream
    "msk_survivor": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # c, W, pos, sync_conj, pp12, masks, sync_pm, sb_out, nbad_out, n_win, F,
    # depth, num_cand, fast, stream
    "msk_demod": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # llr, valid, edge, bit_edges, row_start, check_mask, crc_mask, cw_out,
    # found_out, iters_out, nerr_out, rows, max_iters, fast, stream
    "msk_bp": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
}

_lib = None  # the loaded library, once built
_lib_lock = threading.Lock()  # one build and load per process
_count_lock = threading.Lock()
_recording = threading.local()  # .tally: this thread's capture tally, or None
last_build_seconds = None  # wall time of this process's build, if any


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
    """Compile csrc/*.cu into the hashed library unless it already exists:
    one nvcc per source in parallel, then one link. ptxas's per-kernel
    register/shared-memory report goes to <lib>.log."""
    global last_build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{os.getpid()}.{threading.get_ident()}"
    tmp = out.with_suffix(f".{tag}.tmp")
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    objs = [out.with_suffix(f".{src.stem}.{tag}.o") for src in srcs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-Xptxas=-v", "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for src, obj in zip(srcs, objs)]
    outs = [proc.communicate() for proc in procs]  # waits for every nvcc
    runs = [(src.name, proc.returncode, so, se) for src, proc, (so, se) in zip(srcs, procs, outs)]
    failed = [r for r in runs if r[1] != 0]
    if not failed:
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        runs.append(("link", link.returncode, link.stdout, link.stderr))
        failed = [r for r in runs[-1:] if r[1] != 0]
    last_build_seconds = time.perf_counter() - t0
    out.with_suffix(".log").write_text("".join(so + se for _, _, so, se in runs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        name, rc, _, err = failed[0]
        raise RuntimeError(f"nvcc failed on {name} ({rc}):\n{err[-4000:]}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The kernel library, built on first use, once per process whichever
    thread asks first. Raises if it cannot be built or loaded: a CUDA tensor
    never falls back to the plain path."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
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


@functools.lru_cache(maxsize=None)
def num_sms(device: torch.device) -> int:
    """Streaming multiprocessors of the card (the kernels size their grids
    by it)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def resolve_device(device=None) -> torch.device:
    """The device an entry point decodes on: `device`, or the card when it
    is None. A CUDA device without a card raises: the CPU runs only when
    the caller asks for it ("cpu"). A device torch cannot parse, or of any
    other type, raises ValueError."""
    try:
        dev = torch.device("cuda" if device is None else device)
    except RuntimeError as e:
        raise ValueError(f"unsupported device {device!r}: {e}") from None
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device is available for {dev} "
                           "(pass device='cpu' to run the plain torch path on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use cuda or cpu")
    return dev


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


def count_launch(wrapper, fast: bool = False) -> None:
    """One more launch of `wrapper`'s kernel, its fast instantiation if fast
    (called right after the launch succeeded). Inside `recording()` the
    launch was captured into a graph, not made: it goes to the tally."""
    tally = getattr(_recording, "tally", None)
    if tally is not None:
        tally[wrapper, fast] = tally.get((wrapper, fast), 0) + 1
        return
    add_launches({(wrapper, fast): 1})


def add_launches(tally: dict) -> None:
    """Add a tally {(wrapper, fast): launches} to the counts: a graph's
    replay launches what its capture recorded."""
    with _count_lock:
        for (wrapper, fast), n in tally.items():
            if fast:
                wrapper.launches_fast += n
            else:
                wrapper.launches += n


@contextlib.contextmanager
def recording():
    """This thread's count_launch calls go to the yielded tally instead of
    the counts (a graph capture, which launches nothing)."""
    _recording.tally = tally = {}
    try:
        yield tally
    finally:
        _recording.tally = None


def _wrappers() -> dict:
    from . import demod, ldpc, scan, survivor

    return {"scan": scan.scan_cuda, "survivor": survivor.demod_survivors_cuda,
            "demod": demod.demod_candidates_cuda, "bp": ldpc.bp_decode_cuda}


def launch_counts() -> dict[str, int]:
    """Launches per kernel since the last reset: "scan", "survivor",
    "demod", "bp" (float32), then the same names with "_fast"."""
    ws = _wrappers()
    return {**{k: w.launches for k, w in ws.items()},
            **{f"{k}_fast": w.launches_fast for k, w in ws.items()}}


def reset_launch_counts() -> None:
    with _count_lock:
        for w in _wrappers().values():
            w.launches = w.launches_fast = 0
