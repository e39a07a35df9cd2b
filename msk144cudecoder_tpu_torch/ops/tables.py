"""Per-frequency-grid constant tables and the LDPC/CRC edge tables.

The float64 numpy builder is the JAX package's (msk144cudecoder_tpu/ops/
tables.py), copied because that package's ops/__init__ imports jax:

  B   (42, F) complex64   cb42[i] * exp(+2j pi f i / fs)      (scan correlation)
  E   (N, F)  complex64   exp(+2j pi f l / fs)                (lag phase ramp)
  chi (1, F)  complex64   exp(-2j pi f N / fs) - 1            (wrap correction)
  W   (F, N)  complex64   exp(-2j pi f t / fs)                (demod mix-down)

Phases are reduced mod 1 in float64 on the host before complex64 conversion.
`padded_freqs` extends a grid for frequency sharding.
`to_torch` carries these numpy tables into the port unchanged; the layout
helpers below derive the kernel-friendly forms (E as (F, N/dec), LDPC edges
as flat int32 index tables) from them. `demod_to_torch` and `ldpc_to_torch`
carry the demod's and BP's protocol constants the same way.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import constants as C
from ..protocol import crc as crc_mod
from ..protocol import ldpc_tables as T

_N = C.WINDOW_LEN


class FreqTables(NamedTuple):
    B: np.ndarray  # (42, F) complex64
    E: np.ndarray  # (N, F) complex64
    chi: np.ndarray  # (1, F) complex64
    W: np.ndarray  # (F, N) complex64


def build_freq_tables(freqs: np.ndarray) -> FreqTables:
    freqs = np.asarray(freqs, dtype=np.float64)
    i = np.arange(C.SYNC_CORR_LEN)
    B = C.CB42[:, None] * np.exp(2j * np.pi * freqs[None, :] * i[:, None] / C.SAMPLE_RATE)
    t = np.arange(_N)
    phase = np.mod(np.outer(t, freqs) / C.SAMPLE_RATE, 1.0)
    E = np.exp(2j * np.pi * phase)
    chi = np.exp(-2j * np.pi * freqs * _N / C.SAMPLE_RATE) - 1.0
    W = np.exp(-2j * np.pi * phase.T)
    return FreqTables(
        B=B.astype(np.complex64),
        E=E.astype(np.complex64),
        chi=chi[None, :].astype(np.complex64),
        W=W.astype(np.complex64),
    )


@functools.lru_cache(maxsize=8)
def cached_freq_tables(freqs_key: tuple) -> FreqTables:
    return build_freq_tables(np.asarray(freqs_key))


def padded_freqs(freqs: np.ndarray, multiple: int) -> np.ndarray:
    """Extend the frequency grid upward so its length divides by `multiple`
    (the frequency-sharding pad). The extra channels are real frequencies
    past the right boundary; a channel mask keeps them out of the results."""
    n = len(freqs)
    rem = (-n) % multiple
    if rem == 0:
        return np.asarray(freqs, dtype=np.float64)
    step = freqs[1] - freqs[0] if n > 1 else 1.0
    ext = freqs[-1] + step * np.arange(1, rem + 1)
    return np.concatenate([freqs, ext]).astype(np.float64)


class TorchFreqTables(NamedTuple):
    """The port's frequency tables: the same arrays as FreqTables, as tensors
    on one device, plus the scan kernel's E layout."""

    B: torch.Tensor  # (42, F) complex64
    E: torch.Tensor  # (N, F) complex64
    chi: torch.Tensor  # (F,) complex64
    W: torch.Tensor  # (F, N) complex64


def to_torch(tables: FreqTables, device) -> TorchFreqTables:
    """numpy FreqTables -> tensors on `device`, values unchanged (chi is
    flattened from (1, F) to (F,))."""
    return TorchFreqTables(
        B=torch.from_numpy(np.ascontiguousarray(tables.B)).to(device),
        E=torch.from_numpy(np.ascontiguousarray(tables.E)).to(device),
        chi=torch.from_numpy(np.ascontiguousarray(tables.chi[0])).to(device),
        W=torch.from_numpy(np.ascontiguousarray(tables.W)).to(device),
    )


def e_decimated(E: torch.Tensor, dec: int) -> torch.Tensor:
    """E (N, F) -> (F, N/dec): the lag phase ramp on the coarse lag grid,
    frequency-major and contiguous, so the scan kernel's block for one
    frequency reads consecutive lags."""
    return E[::dec, :].transpose(0, 1).contiguous()


class DemodTables(NamedTuple):
    """The survivor demod's constants on one device."""

    sync_conj: torch.Tensor  # (42,) complex64 conj(cb42), both sync regions
    pp12: torch.Tensor  # (12,) float32 half-sine matched-filter taps
    masks: torch.Tensor  # (8, 6) int32 frame masks of the averaging patterns
    sync_pm: torch.Tensor  # (8,) int32 sync word as +-1


def demod_to_torch(device) -> DemodTables:
    return DemodTables(
        sync_conj=torch.from_numpy(np.conj(C.CB42).astype(np.complex64)).to(device),
        pp12=torch.from_numpy(C.PP12.astype(np.float32)).to(device),
        masks=torch.from_numpy(C.PATTERN_MASKS.astype(np.int32)).to(device),
        sync_pm=torch.from_numpy(C.SYNC_WORD_PM.astype(np.int32)).to(device),
    )


class TorchLdpcTables(NamedTuple):
    nm: torch.Tensor  # (38, 11) int32 bit index per (check, slot), -1 pad
    mn_edge: torch.Tensor  # (128, 3) int32 flat edge 11*check + slot
    crc: torch.Tensor  # (13, 77) uint8 CRC-13 GF(2) matrix
    # kernel B3's forms. The 384 real edges in (check, slot) order:
    edge: torch.Tensor  # (384,) int32 bit | check << 8
    bit_edges: torch.Tensor  # (128,) int32 the bit's 3 real edges, 9 bits each
    row_start: torch.Tensor  # (39,) int32 first real edge of each check
    # 32-bit words (int32 bit patterns); bit b of word w stands for codeword
    # bit 32w + b
    check_mask: torch.Tensor  # (38, 4) the bits of each parity check
    crc_mask: torch.Tensor  # (13, 3) the message bits of each CRC row


def pack_words(bits: np.ndarray) -> np.ndarray:
    """(..., n) 0/1 -> (..., ceil(n/32)) int32: bit b of word w is bits[32w + b]."""
    n = bits.shape[-1]
    padded = np.zeros(bits.shape[:-1] + (-(-n // 32) * 32,), np.uint64)
    padded[..., :n] = bits
    words = padded.reshape(bits.shape[:-1] + (-1, 32)) << np.arange(32, dtype=np.uint64)
    return words.sum(axis=-1).astype(np.uint32).view(np.int32)


def ldpc_to_torch(device) -> TorchLdpcTables:
    """ldpc_tables.NM / MN and crc.CRC_MATRIX as tensors on `device`, and
    kernel B3's packed forms of them."""
    mn = T.MN.astype(np.int32)  # (128, 3, 2): (check, slot) per bit
    mn_edge = mn[..., 0] * T.MAX_ROW_DEGREE + mn[..., 1]
    real = (T.NM >= 0).reshape(-1)
    compact = np.cumsum(real) - 1  # flat edge -> its index among the real edges
    checks = np.repeat(np.arange(T.N_CHECKS), T.MAX_ROW_DEGREE)[real]
    edge = T.NM.reshape(-1)[real] | checks << 8
    ce = compact[mn_edge]  # (128, 3)
    bit_edges = ce[:, 0] | ce[:, 1] << 9 | ce[:, 2] << 18
    row_start = np.concatenate([[0], np.cumsum((T.NM >= 0).sum(axis=1))])
    on_check = np.zeros((T.N_CHECKS, T.N_BITS), np.uint8)
    for r in range(T.N_CHECKS):
        on_check[r, T.NM[r][T.NM[r] >= 0]] = 1

    def put(a, dtype=np.int32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return TorchLdpcTables(
        nm=put(T.NM), mn_edge=put(mn_edge), crc=put(crc_mod.CRC_MATRIX, np.uint8),
        edge=put(edge), bit_edges=put(bit_edges), row_start=put(row_start),
        check_mask=put(pack_words(on_check)),
        crc_mask=put(pack_words(crc_mod.CRC_MATRIX.astype(np.uint8))),
    )
