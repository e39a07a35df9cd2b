"""Softbit demodulation of extracted 864-sample frames (plain torch).

Port of msk144cudecoder_tpu/ops/softbits.py::demod. Per frame: carrier-phase
estimate over both 42-sample sync regions, derotation, the 12-sample
half-sine matched filter giving 144 interleaved Q/I softbits, normalisation
by 2/(ssig * sigma^2), the 128 data softbits and the nbadsync sync-quality
count. The matched filter is an index gather over the taps instead of the
JAX package's (864, 72) tap matrices. The survivor demod (ops/survivor.py)
feeds it; kernel B2 (csrc/survivor.cu) computes the same tail in the block.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import constants as C
from .tables import DemodTables


@functools.lru_cache(maxsize=None)
def mf_index() -> tuple[np.ndarray, np.ndarray]:
    """(idx_q, idx_i), each (72, 12) int64: the frame rows of softbit q's
    12 taps on the Q rail, (858 + 12q + i) mod 864, and on the I rail,
    12q + i. Softbit 2q is the Q rail's, 2q + 1 the I rail's."""
    q = np.arange(72)[:, None]
    i = np.arange(12)[None, :]
    return (858 + 12 * q + i) % C.FRAME_LEN, 12 * q + i


def demod(frames: torch.Tensor, dt: DemodTables) -> tuple[torch.Tensor, torch.Tensor]:
    """frames (..., 864) complex64 -> (softbits (..., 128) float32,
    nbadsync (...) int32)."""
    dev = frames.device
    taps = C.SYNC_CORR_LEN
    s = ((frames[..., :taps] * dt.sync_conj).sum(dim=-1)
         + (frames[..., C.SECOND_SYNC_SAMPLE : C.SECOND_SYNC_SAMPLE + taps]
            * dt.sync_conj).sum(dim=-1))
    phase0 = torch.atan2(s.imag, s.real)
    cfac = torch.complex(torch.cos(phase0), -torch.sin(phase0))
    d = frames * cfac[..., None]

    idx_q, idx_i = (torch.from_numpy(a).to(dev) for a in mf_index())
    sb_q = (d.imag[..., idx_q] * dt.pp12).sum(dim=-1)  # (..., 72)
    sb_i = (d.real[..., idx_i] * dt.pp12).sum(dim=-1)
    shape = d.shape[:-1]
    sb = torch.stack([sb_q, sb_i], dim=-1).reshape(shape + (C.NUM_CHANNEL_BITS,))

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
