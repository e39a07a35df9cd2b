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

With fast=True (DecoderConfig.fast_math) the plain version rounds where the
JAX kernel's fast mode does (ops/precision.py, B2): the window, the table
values and gamma round to bf16, the mix, the pattern sum and the carrier
W[f, 128j + r] = W[f, 128j] * W[f, r] are in bf16, and the matched filter
takes bf16 operands.

`demod_survivors` dispatches on the device of the window: a CUDA tensor goes
to the hand-written kernel (csrc/survivor.cu) or raises; a CPU tensor runs
the plain version. Every row carries its own pattern, so one call covers all
pattern tiers of a window batch.
"""

from __future__ import annotations

import torch

from .. import constants as C
from . import kernels
from .precision import cmul_bf16, round_bf16, round_complex
from .softbits import demod, sync_near_zero
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


def _cmul(ar, ai, br, bi):
    """(ar + i ai) * (br + i bi) in float32, each product and sum rounded on
    its own (kernel B2's cmul_rn)."""
    return ar * br - ai * bi, ar * bi + ai * br


def survivor_params_fast(pos: torch.Tensor, f_idx: torch.Tensor, p_idx: torch.Tensor,
                         W: torch.Tensor, chi: torch.Tensor,
                         masks: torch.Tensor) -> torch.Tensor:
    """survivor_params in fast mode: gamma[m, 0..1] (..., 6, 2) complex64 from
    the table values W[f, 128q], W[f, r], W[f, 864m] and conj(1 + chi)
    rounded to bf16 (the JAX kernel's one bf16 pass of the table fetch),
    the products in float32, then gamma rounded to bf16 (k <= 1 for the
    port's 864-sample frames)."""
    pos = pos.long()
    f = f_idx.long()
    q0 = torch.div(pos, 128, rounding_mode="floor")
    wq = round_complex(W[f, 128 * q0])
    wr = round_complex(W[f, pos - 128 * q0])
    m864 = torch.arange(_M, device=W.device) * C.FRAME_LEN
    t864 = round_complex(W[f[..., None], m864])  # (..., 6)
    phi = round_complex(torch.conj(1.0 + chi[f]))[..., None]
    mask = masks[p_idx.long()].to(torch.float32)  # (..., 6)
    wp_r, wp_i = _cmul(wq.real, wq.imag, wr.real, wr.imag)
    a_r, a_i = _cmul(mask, torch.zeros_like(mask), wp_r[..., None], wp_i[..., None])
    g0_r, g0_i = _cmul(a_r, a_i, t864.real, t864.imag)
    g1_r, g1_i = _cmul(g0_r, g0_i, phi.real, phi.imag)
    return torch.stack([round_complex(torch.complex(g0_r, g0_i)),
                        round_complex(torch.complex(g1_r, g1_i))], dim=-1)


def frame_fast(vals: torch.Tensor, g: torch.Tensor, W: torch.Tensor,
               f_idx: torch.Tensor) -> torch.Tensor:
    """The fast mode's frames (..., 864) complex64 from the bf16 window
    samples vals and gammas g (..., 6, 864): the mix and the sum over the
    six frames in ascending m, then the carrier W[f, 128j] * W[f, r] of
    sample l = 128j + r, each operation in bf16."""
    acc_r = torch.zeros(vals.shape[:-2] + vals.shape[-1:], device=vals.device)
    acc_i = torch.zeros_like(acc_r)
    for m in range(_M):
        zr, zi = cmul_bf16(vals.real[..., m, :], vals.imag[..., m, :],
                           g.real[..., m, :], g.imag[..., m, :])
        acc_r, acc_i = round_bf16(acc_r + zr), round_bf16(acc_i + zi)
    lane = torch.arange(C.FRAME_LEN, device=W.device)
    f = f_idx.long()[..., None]
    q = round_complex(W[f, 128 * torch.div(lane, 128, rounding_mode="floor")])
    w = round_complex(W[f, lane % 128])
    car_r, car_i = cmul_bf16(q.real, q.imag, w.real, w.imag)
    return torch.complex(*cmul_bf16(acc_r, acc_i, car_r, car_i))


def survivor_frames_plain(c: torch.Tensor, W: torch.Tensor, chi: torch.Tensor,
                          pos: torch.Tensor, f_idx: torch.Tensor, p_idx: torch.Tensor,
                          dt: DemodTables, fast: bool = False) -> torch.Tensor:
    """The survivors' pattern-averaged, mixed-down frames (B, S, 864)
    complex64 for windows c (B, N) and rows pos, f_idx, p_idx (B, S); fast:
    rounded as the JAX kernel's fast mode."""
    dev = c.device
    if fast:
        c = round_complex(c)
        gam = survivor_params_fast(pos, f_idx, p_idx, W, chi, dt.masks)  # (B, S, 6, 2)
    else:
        gam = survivor_params(pos, f_idx, p_idx, W, chi, dt.masks)  # (B, S, 6, 3)
    m = torch.arange(_M, device=dev)[:, None] * C.FRAME_LEN
    lane = torch.arange(C.FRAME_LEN, device=dev)[None, :]
    idx = pos.long()[..., None, None] + m + lane  # (B, S, 6, 864)
    k = torch.div(idx, _N, rounding_mode="floor")
    vals = torch.gather(c[:, None, :].expand(-1, idx.shape[1], -1), 2,
                        (idx - k * _N).reshape(idx.shape[0], idx.shape[1], -1))
    vals = vals.reshape(idx.shape)
    g = torch.gather(gam, -1, k.reshape(idx.shape[:3] + (-1,))).reshape(idx.shape)
    if fast:
        return frame_fast(vals, g, W, f_idx)
    frame = (vals * g).sum(dim=2)  # (B, S, 864)
    return frame * W[f_idx.long(), : C.FRAME_LEN]


def demod_survivors_plain(c: torch.Tensor, W: torch.Tensor, chi: torch.Tensor,
                          pos: torch.Tensor, f_idx: torch.Tensor,
                          p_idx: torch.Tensor, dt: DemodTables, fast: bool = False
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch survivor demod. c (B, N) complex64 windows; pos, f_idx,
    p_idx (B, S) int. Returns (softbits (B, S, 128) float32, nbadsync (B, S)
    int32). fast: rounded as the JAX kernel's fast mode."""
    return demod(survivor_frames_plain(c, W, chi, pos, f_idx, p_idx, dt, fast), dt, fast)


def nbadsync_agreement(c: torch.Tensor, W: torch.Tensor, chi: torch.Tensor,
                       pos: torch.Tensor, f_idx: torch.Tensor, p_idx: torch.Tensor,
                       dt: DemodTables, nbad_a: torch.Tensor, nbad_b: torch.Tensor,
                       near: float, fast: bool = False) -> tuple[int, bool]:
    """How two nbadsync grids (B, S) of the same survivor rows agree: (count
    of unequal rows, whether every unequal row has a plain sync-bit softbit
    with |sb| < near before scaling). nbadsync counts those softbits' signs,
    so a kernel and its plain version can disagree only where one is near 0."""
    mism = nbad_a != nbad_b
    n = int(mism.sum())
    if not n:
        return 0, True
    # the unequal rows, one window each: (n, N) windows of one row
    b = mism.nonzero()[:, 0]
    frames = survivor_frames_plain(c[b], W, chi, *(t[mism][:, None] for t in (pos, f_idx, p_idx)),
                                   dt, fast)
    return n, sync_near_zero(frames[:, 0], dt, near, fast)


WARPS_PER_BLOCK = 8


def rows_per_block(S: int, n_win: int, sms: int) -> int:
    """Rows per block of kernel B2 for n_win windows of S rows. A block
    stages its window once and runs its rows on min(rows, 8) warps: the most
    of 32, 16 and 8 rows, no more than S, whose grid of n_win * ceil(S /
    rows) blocks still gives every SM one, else min(S, 8)."""
    for rows in (32, 16, 8):
        if rows <= S and n_win * -(-S // rows) >= sms:
            return rows
    return min(S, WARPS_PER_BLOCK)


def demod_survivors_cuda(c: torch.Tensor, W: torch.Tensor, chi: torch.Tensor,
                         pos: torch.Tensor, f_idx: torch.Tensor,
                         p_idx: torch.Tensor, dt: DemodTables, fast: bool = False
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B2 (csrc/survivor.cu): one warp per survivor row, blocks of
    rows_per_block rows of one window on up to 8 warps, B * S rows in one
    launch; fast launches its bf16 instantiation (its matched filter on the
    tensor cores; c 16-byte aligned). c (B, N) complex64; W
    (F, N) complex64; chi (F,) complex64; pos/f_idx/p_idx (B, S) int32, all
    contiguous on one CUDA device."""
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
    if fast and c.data_ptr() % 16:
        raise ValueError("demod_survivors: the bf16 kernel reads c 16 bytes at a time; "
                         "c must be 16-byte aligned")
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
                                  rows_per_block(S, nw, kernels.num_sms(c.device)),
                                  int(fast), kernels.stream_ptr(c.device))
        kernels.raise_on_error("msk_survivor", rc)
        kernels.count_launch(demod_survivors_cuda, fast)
    return sb, nbad


demod_survivors_cuda.launches = 0
demod_survivors_cuda.launches_fast = 0


def demod_survivors(c: torch.Tensor, W: torch.Tensor, chi: torch.Tensor,
                    pos: torch.Tensor, f_idx: torch.Tensor,
                    p_idx: torch.Tensor, dt: DemodTables, fast: bool = False
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Survivor demod of windows c (B, N): kernel B2 on a CUDA tensor, the
    plain version on the CPU."""
    if kernels.on_cuda(c):
        return demod_survivors_cuda(c, W, chi, pos, f_idx, p_idx, dt, fast)
    return demod_survivors_plain(c, W, chi, pos, f_idx, p_idx, dt, fast)
