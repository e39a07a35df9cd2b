"""Softbit demodulation of extracted 864-sample frames (plain torch).

Port of msk144cudecoder_tpu/ops/softbits.py. `demod`, per frame:
carrier-phase estimate over both 42-sample sync regions, derotation, the
12-sample half-sine matched filter giving 144 interleaved Q/I softbits,
normalisation by 2/(ssig * sigma^2), the 128 data softbits and the nbadsync
sync-quality count. The matched filter is an index gather over the taps
instead of the JAX package's (864, 72) tap matrices. The survivor demod
(ops/survivor.py) feeds it; kernels B2 and B4 (csrc/survivor.cu, csrc/demod.cu)
compute the same tail on one warp per frame (csrc/common.cuh warp_tail).

`demod_candidates` is the full demod of every scan candidate, batched over
windows: mix each window down once per frequency (`mix_all`), sum the
pattern's frames once per (frequency, pattern) (`pattern_average`), cut each
candidate's frame from that sum (`gather_frames`), then `demod`. It is the
plain version of kernel B4 (ops/demod.py, csrc/demod.cu).

With fast=True (DecoderConfig.fast_math) `demod` rounds the frame samples
and the taps (pp12, conj(cb42)) to bf16 once, the operands of the JAX
kernels' bf16 matched-filter dot, and takes every sum and the derotation
after that in float32 (ops/precision.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import constants as C
from .precision import round_bf16, round_complex
from .tables import DemodTables


@functools.lru_cache(maxsize=None)
def mf_index() -> tuple[np.ndarray, np.ndarray]:
    """(idx_q, idx_i), each (72, 12) int64: the frame rows of softbit q's
    12 taps on the Q rail, (858 + 12q + i) mod 864, and on the I rail,
    12q + i. Softbit 2q is the Q rail's, 2q + 1 the I rail's."""
    q = np.arange(72)[:, None]
    i = np.arange(12)[None, :]
    return (858 + 12 * q + i) % C.FRAME_LEN, 12 * q + i


def channel_softbits(frames: torch.Tensor, dt: DemodTables, fast: bool = False) -> torch.Tensor:
    """frames (..., 864) complex64 -> the 144 unscaled channel softbits
    (..., 144) float32 of the carrier-derotated matched filter; fast: the
    frames and taps rounded to bf16 first."""
    dev = frames.device
    taps = C.SYNC_CORR_LEN
    sync_conj, pp12 = dt.sync_conj, dt.pp12
    if fast:
        frames, sync_conj, pp12 = round_complex(frames), round_complex(sync_conj), round_bf16(pp12)
    s = ((frames[..., :taps] * sync_conj).sum(dim=-1)
         + (frames[..., C.SECOND_SYNC_SAMPLE : C.SECOND_SYNC_SAMPLE + taps]
            * sync_conj).sum(dim=-1))
    phase0 = torch.atan2(s.imag, s.real)
    cfac = torch.complex(torch.cos(phase0), -torch.sin(phase0))
    d = frames * cfac[..., None]

    idx_q, idx_i = (torch.from_numpy(a).to(dev) for a in mf_index())
    sb_q = (d.imag[..., idx_q] * pp12).sum(dim=-1)  # (..., 72)
    sb_i = (d.real[..., idx_i] * pp12).sum(dim=-1)
    return torch.stack([sb_q, sb_i], dim=-1).reshape(d.shape[:-1] + (C.NUM_CHANNEL_BITS,))


def sync_softbits(frames: torch.Tensor, dt: DemodTables, fast: bool = False) -> torch.Tensor:
    """frames (..., 864) complex64 -> the 16 unscaled sync-bit softbits
    (..., 16) float32, channel bits 0-7 and 56-63, whose signs nbadsync
    counts."""
    sb = channel_softbits(frames, dt, fast)
    return torch.cat([sb[..., C.FIRST_SYNC_BIT : C.FIRST_SYNC_BIT + 8],
                      sb[..., C.SECOND_SYNC_BIT : C.SECOND_SYNC_BIT + 8]], dim=-1)


def sync_near_zero(frames: torch.Tensor, dt: DemodTables, near: float,
                   fast: bool = False) -> bool:
    """Whether every frame (..., 864) has a sync-bit softbit with |sb| < near
    before scaling: the one case where a kernel and its plain version may
    count nbadsync differently, since it counts those softbits' signs."""
    return bool((sync_softbits(frames, dt, fast).abs().amin(dim=-1) < near).all())


def demod(frames: torch.Tensor, dt: DemodTables,
          fast: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """frames (..., 864) complex64 -> (softbits (..., 128) float32,
    nbadsync (...) int32)."""
    dev = frames.device
    sb = channel_softbits(frames, dt, fast)
    shape = sb.shape[:-1]
    sav = sb.mean(dim=-1, keepdim=True)
    s2av = (sb * sb).mean(dim=-1, keepdim=True)
    ssig = torch.sqrt(torch.clamp_min(s2av - sav * sav, 1e-30))
    scale = 2.0 / (ssig * (C.SOFTBIT_SIGMA ** 2))
    sb_wo_sync = scale * torch.cat([sb[..., 8:56], sb[..., 64:144]], dim=-1)

    nbad = torch.zeros(shape, dtype=torch.int32, device=dev)
    for base in (C.FIRST_SYNC_BIT, C.SECOND_SYNC_BIT):
        hard = torch.where(sb[..., base : base + 8] < 0.0, -1, 1).to(torch.int32)
        nbad = nbad + ((8 - (hard * dt.sync_pm).sum(dim=-1)) // 2).to(torch.int32)
    return sb_wo_sync, nbad


def mix_all(c: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Windows c (B, N) and the mix table W (F, N) = exp(-2j pi f t / fs) on
    wrapped indices t -> (B, F, N) mixed-down windows."""
    return c[:, None, :] * W


def pattern_average(z: torch.Tensor, scan_depth: int) -> torch.Tensor:
    """(B, F, N) -> (B, F, P, N): ZA_p = sum_m mask_p[m] * roll(z, -864m),
    the patterns 0-5 as prefix sums, the gap patterns 6 = {0, 3} and
    7 = {0, 3, 4} on their own, each summed in ascending m."""
    rolls = [torch.roll(z, -C.FRAME_LEN * m, dims=-1) for m in range(C.PATTERN_LEN)]
    out = [rolls[0]]
    for m in range(1, C.PATTERN_LEN):
        out.append(out[-1] + rolls[m])
    out.append(rolls[0] + rolls[3])
    out.append(out[-1] + rolls[4])
    return torch.stack(out[:scan_depth], dim=2)


def gather_frames(za: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """za (B, F, P, N), pos (B, F, P, k) -> frames (B, F, P, k, 864):
    za[(pos + l) mod N], l < 864."""
    zad = torch.cat([za, za[..., : C.FRAME_LEN - 1]], dim=-1)
    idx = pos.long()[..., None] + torch.arange(C.FRAME_LEN, device=za.device)
    k = pos.shape[-1]
    frames = torch.gather(zad, -1, idx.reshape(idx.shape[:3] + (-1,)))
    return frames.reshape(frames.shape[:3] + (k, C.FRAME_LEN))


def demod_candidates(c: torch.Tensor, W: torch.Tensor, pos: torch.Tensor,
                     dt: DemodTables, fast: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Full demod of every scan candidate. c (B, N) complex64 windows, W
    (F, N) complex64, pos (B, F, P, k) int -> (softbits (B, F, P, k, 128)
    float32, nbadsync (B, F, P, k) int32). fast: the matched filter on bf16
    operands; the mix and the pattern sums stay float32."""
    za = pattern_average(mix_all(c, W), pos.shape[2])
    return demod(gather_frames(za, pos), dt, fast)
