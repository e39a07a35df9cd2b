"""Survivor demod: the plain torch version and the kernel B2 wrapper.

Port of msk144cudecoder_tpu/ops/pallas_survivor.py (survivor_params,
demod_survivors_ref) and of the kernel _survivor_kernel with its tail
pallas_demod.mf_tail. Per prefiltered survivor (pos, f, p) the pattern-
averaged, mixed-down frame is

    frame[l] = W[f, l] * sum_{m in mask_p} gamma[m, k] * c[(pos + 864m + l) mod N]
    k        = (pos + 864m + l) // N,     l < 864
    gamma[m, 0]   = W[f, pos] * W[f, 864m]
    gamma[m, k+1] = gamma[m, k] * conj(1 + chi_f)

with W[f, pos] = W[f, 128 * (pos // 128)] * W[f, pos % 128] as in the JAX
package, so every factor is an exact table value and the only rounding is the
float32 products themselves. The frame then goes through softbits.demod.

`demod_survivors` dispatches on the device of the window: a CUDA tensor goes
to the hand-written kernel (csrc/survivor.cu) or raises; a CPU tensor runs
the plain version. Every row carries its own pattern, so one call covers all
pattern tiers of a window batch.
"""

from __future__ import annotations

import torch

from .. import constants as C
from . import kernels
from .softbits import demod
from .tables import DemodTables

_N = C.WINDOW_LEN
_M = C.PATTERN_LEN


def survivor_params(pos: torch.Tensor, f_idx: torch.Tensor, p_idx: torch.Tensor,
                    W: torch.Tensor, chi: torch.Tensor,
                    masks: torch.Tensor) -> torch.Tensor:
    """gamma (..., 6, 3) complex64 for survivors pos/f_idx/p_idx (...) int.

    W (F, N) complex64 mix table, chi (F,) complex64 wrap correction, masks
    (8, 6) the patterns' frame masks (tables.DemodTables). Rows
    of masked-out frames are zero (the JAX flat layout: adding exact zeros
    leaves the pattern sum unchanged)."""
    pos = pos.long()
    f = f_idx.long()
    q0 = torch.div(pos, 128, rounding_mode="floor")
    r0 = pos - 128 * q0
    w_pos = W[f, 128 * q0] * W[f, r0]
    t864 = W[f][..., :: C.FRAME_LEN][..., :_M]  # (..., 6) = W[f, 864m]
    phi = torch.conj(1.0 + chi[f])
    mask = masks[p_idx.long()].to(W.dtype)  # (..., 6)
    g0 = mask * w_pos[..., None] * t864
    g1 = g0 * phi[..., None]
    g2 = g1 * phi[..., None]
    return torch.stack([g0, g1, g2], dim=-1)


def demod_survivors_plain(c: torch.Tensor, W: torch.Tensor, chi: torch.Tensor,
                          pos: torch.Tensor, f_idx: torch.Tensor,
                          p_idx: torch.Tensor, dt: DemodTables
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch survivor demod. c (B, N) complex64 windows; pos, f_idx,
    p_idx (B, S) int. Returns (softbits (B, S, 128) float32, nbadsync (B, S)
    int32)."""
    dev = c.device
    gam = survivor_params(pos, f_idx, p_idx, W, chi, dt.masks)  # (B, S, 6, 3)
    m = torch.arange(_M, device=dev)[:, None] * C.FRAME_LEN
    lane = torch.arange(C.FRAME_LEN, device=dev)[None, :]
    idx = pos.long()[..., None, None] + m + lane  # (B, S, 6, 864)
    k = torch.div(idx, _N, rounding_mode="floor")
    vals = torch.gather(c[:, None, :].expand(-1, idx.shape[1], -1), 2,
                        (idx - k * _N).reshape(idx.shape[0], idx.shape[1], -1))
    vals = vals.reshape(idx.shape)
    g = torch.gather(gam, -1, k.reshape(idx.shape[:3] + (-1,))).reshape(idx.shape)
    frame = (vals * g).sum(dim=2)  # (B, S, 864)
    frame = frame * W[f_idx.long(), : C.FRAME_LEN]
    return demod(frame, dt)


def demod_survivors_cuda(c: torch.Tensor, W: torch.Tensor, chi: torch.Tensor,
                         pos: torch.Tensor, f_idx: torch.Tensor,
                         p_idx: torch.Tensor, dt: DemodTables
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B2 (csrc/survivor.cu): one block per survivor row, B * S rows
    in one launch. c (B, N) complex64; W (F, N) complex64; chi (F,)
    complex64; pos/f_idx/p_idx (B, S) int32, all contiguous on one CUDA
    device."""
    nw = c.shape[0] if c.dim() == 2 else -1
    F = W.shape[0]
    S = pos.shape[-1] if pos.dim() == 2 else -1
    kernels.check_tensors("demod_survivors",
                          c=(c, torch.complex64, (nw, _N)),
                          W=(W, torch.complex64, (F, _N)),
                          chi=(chi, torch.complex64, (F,)),
                          pos=(pos, torch.int32, (nw, S)),
                          f_idx=(f_idx, torch.int32, (nw, S)),
                          p_idx=(p_idx, torch.int32, (nw, S)),
                          sync_conj=(dt.sync_conj, torch.complex64, (C.SYNC_CORR_LEN,)),
                          pp12=(dt.pp12, torch.float32, (12,)),
                          masks=(dt.masks, torch.int32, (8, _M)),
                          sync_pm=(dt.sync_pm, torch.int32, (C.SYNC_LEN_BITS,)))
    sb = torch.empty((nw, S, C.NUM_DATA_BITS), dtype=torch.float32, device=c.device)
    nbad = torch.empty((nw, S), dtype=torch.int32, device=c.device)
    if nw and S:
        lib = kernels.library()
        with torch.cuda.device(c.device):
            rc = lib.msk_survivor(c.data_ptr(), W.data_ptr(), chi.data_ptr(),
                                  pos.data_ptr(), f_idx.data_ptr(), p_idx.data_ptr(),
                                  dt.sync_conj.data_ptr(), dt.pp12.data_ptr(),
                                  dt.masks.data_ptr(), dt.sync_pm.data_ptr(),
                                  sb.data_ptr(), nbad.data_ptr(), nw, S, F,
                                  kernels.stream_ptr(c.device))
        kernels.raise_on_error("msk_survivor", rc)
        demod_survivors_cuda.launches += 1
    return sb, nbad


demod_survivors_cuda.launches = 0


def demod_survivors(c: torch.Tensor, W: torch.Tensor, chi: torch.Tensor,
                    pos: torch.Tensor, f_idx: torch.Tensor,
                    p_idx: torch.Tensor, dt: DemodTables
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Survivor demod of windows c (B, N): kernel B2 on a CUDA tensor, the
    plain version on the CPU."""
    if kernels.on_cuda(c):
        return demod_survivors_cuda(c, W, chi, pos, f_idx, p_idx, dt)
    return demod_survivors_plain(c, W, chi, pos, f_idx, p_idx, dt)
