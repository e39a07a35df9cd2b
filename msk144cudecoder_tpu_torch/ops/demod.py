"""Full demod of every scan candidate: the plain torch version and the kernel
B4 wrapper.

Port of msk144cudecoder_tpu/ops/pallas_demod.py (demod_pallas and its kernel
_demod_kernel with the tail mf_tail), whose jnp reference is
softbits.demod_candidates. It runs when the xb prefilter is off
(survivor_prefilter=0): every (frequency, pattern, lag) candidate of the
scan is demodulated, and the survivor count is exact.

`demod_candidates` dispatches on the device of the windows: a CUDA tensor
goes to the hand-written kernel (csrc/demod.cu) or raises; a CPU tensor runs
the plain version (softbits.demod_candidates).
"""

from __future__ import annotations

import torch

from .. import constants as C
from . import kernels
from .softbits import gather_frames, pattern_average, sync_near_zero, sync_softbits
from .softbits import demod_candidates as demod_candidates_plain
from .tables import DemodTables

_N = C.WINDOW_LEN
_M = C.PATTERN_LEN

__all__ = ["demod_candidates", "demod_candidates_cuda", "demod_candidates_plain",
           "nbadsync_agreement", "sync_softbits_plain"]


def demod_candidates_cuda(c: torch.Tensor, W: torch.Tensor, pos: torch.Tensor,
                          dt: DemodTables, fast: bool = False
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B4 (csrc/demod.cu): one block per (window, frequency), all
    B * F blocks in one launch, a pattern's candidates on a warp each; fast
    launches its bf16 instantiation. c (B, N) complex64; W (F, N) complex64;
    pos (B, F, P, k) int32 with P <= 8 and k <= 8, all contiguous on one
    CUDA device. Returns (softbits (B, F, P, k, 128) float32, nbadsync
    (B, F, P, k) int32)."""
    nw = c.shape[0] if c.dim() == 2 else -1
    F = W.shape[0]
    P, k = (pos.shape[2], pos.shape[3]) if pos.dim() == 4 else (-1, -1)
    kernels.check_tensors("demod_candidates",
                          c=(c, torch.complex64, (nw, _N)),
                          W=(W, torch.complex64, (F, _N)),
                          pos=(pos, torch.int32, (nw, F, P, k)),
                          sync_conj=(dt.sync_conj, torch.complex64, (C.SYNC_CORR_LEN,)),
                          pp12=(dt.pp12, torch.float32, (12,)),
                          masks=(dt.masks, torch.int32, (8, _M)),
                          sync_pm=(dt.sync_pm, torch.int32, (C.SYNC_LEN_BITS,)))
    if not 1 <= P <= C.SCAN_DEPTH_MAX:
        raise ValueError(f"demod_candidates: scan depth must be in [1, 8], got {P}")
    if not 1 <= k <= C.NUM_CANDIDATES_PER_PATTERN:
        raise ValueError(f"demod_candidates: candidates per pattern must be in [1, 8], got {k}")
    sb = torch.empty((nw, F, P, k, C.NUM_DATA_BITS), dtype=torch.float32, device=c.device)
    nbad = torch.empty((nw, F, P, k), dtype=torch.int32, device=c.device)
    if nw and F:
        lib = kernels.library()
        with torch.cuda.device(c.device):
            rc = lib.msk_demod(c.data_ptr(), W.data_ptr(), pos.data_ptr(),
                               dt.sync_conj.data_ptr(), dt.pp12.data_ptr(),
                               dt.masks.data_ptr(), dt.sync_pm.data_ptr(),
                               sb.data_ptr(), nbad.data_ptr(), nw, F, P, k, int(fast),
                               kernels.stream_ptr(c.device))
        kernels.raise_on_error("msk_demod", rc)
        kernels.count_launch(demod_candidates_cuda, fast)
    return sb, nbad


demod_candidates_cuda.launches = 0
demod_candidates_cuda.launches_fast = 0


def candidate_frames_plain(c: torch.Tensor, W: torch.Tensor, pos: torch.Tensor,
                           rows: torch.Tensor) -> torch.Tensor:
    """The frames (R, 864) complex64 of the candidates rows (R, 4) =
    (window, f, p, j) indices into pos (B, F, P, k), by the plain version."""
    b, f, p, j = (rows[:, i].long() for i in range(4))
    za = pattern_average((c[b] * W[f])[:, None, :], pos.shape[2])[:, 0]  # (R, P, N)
    za = za[torch.arange(len(rows), device=c.device), p]
    return gather_frames(za[:, None, None, :], pos[b, f, p, j][:, None, None, None])[:, 0, 0, 0]


def sync_softbits_plain(c: torch.Tensor, W: torch.Tensor, pos: torch.Tensor,
                        rows: torch.Tensor, dt: DemodTables, fast: bool = False) -> torch.Tensor:
    """The 16 unscaled sync-bit softbits (channel bits 0-7 and 56-63) of the
    candidates rows (R, 4) = (window, f, p, j) indices into pos (B, F, P, k),
    by the plain version: nbadsync counts their signs, so a kernel and the
    plain version can disagree on it only where one of them is near 0."""
    return sync_softbits(candidate_frames_plain(c, W, pos, rows), dt, fast)


def nbadsync_agreement(c: torch.Tensor, W: torch.Tensor, pos: torch.Tensor,
                       dt: DemodTables, nbad_a: torch.Tensor, nbad_b: torch.Tensor,
                       near: float = 1e-3, fast: bool = False) -> tuple[float, int, bool]:
    """How two nbadsync grids (B, F, P, k) of the same candidates agree:
    (share of equal rows, count of unequal rows, whether every unequal row
    has a plain sync-bit softbit with |sb| < near before scaling; fast: by
    the fast plain version)."""
    mism = nbad_a != nbad_b
    n = int(mism.sum())
    if not n:
        return 1.0, 0, True
    frames = candidate_frames_plain(c, W, pos, mism.nonzero())
    return 1.0 - n / mism.numel(), n, sync_near_zero(frames, dt, near, fast)


def demod_candidates(c: torch.Tensor, W: torch.Tensor, pos: torch.Tensor,
                     dt: DemodTables, fast: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Full demod of windows c (B, N) at scan positions pos (B, F, P, k):
    kernel B4 on a CUDA tensor, the plain version on the CPU."""
    if kernels.on_cuda(c):
        return demod_candidates_cuda(c, W, pos, dt, fast)
    return demod_candidates_plain(c, W, pos, dt, fast)
