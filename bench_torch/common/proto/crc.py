"""CRC-13 for the MSK144 77-bit payload (poly 0x15D7).

Semantics match the reference check (reference src/ldpc_kernel.cuh:32-63):
the 13-bit CRC is computed MSB-first over a 96-bit buffer holding the 77
message bits followed by 19 zero bits, with zero initial remainder and no
final XOR. Codeword bits [77..90) carry the CRC.

Because init=0 and there is no final XOR, the CRC is linear over GF(2) in the
input bits; `CRC_MATRIX` lets a batched decoder verify CRCs with one
(13 x 77) GF(2) mat-vec instead of a 96-step serial loop.
"""

from __future__ import annotations

import numpy as np

CRC13_POLY = 0x15D7
CRC_LEN = 13
MSG_LEN = 77
PADDED_LEN = 96  # 12 bytes


def crc13_bits(bits77: np.ndarray) -> np.ndarray:
    """Serial MSB-first CRC-13 over 77 message bits (oracle implementation)."""
    bits = np.zeros(PADDED_LEN, dtype=np.uint8)
    bits[:MSG_LEN] = np.asarray(bits77, dtype=np.uint8)
    rem = 0
    for b in bits:
        top = (rem >> (CRC_LEN - 1)) & 1
        rem = ((rem << 1) | int(b)) & ((1 << CRC_LEN) - 1)
        if top:
            rem ^= CRC13_POLY & ((1 << CRC_LEN) - 1)
    # One more polynomial-division nuance: the loop above folds each input bit
    # into the remainder before reduction, which equals the reference's
    # byte-table algorithm (shift-in then XOR table of the out-shifted byte).
    out = np.array([(rem >> (CRC_LEN - 1 - i)) & 1 for i in range(CRC_LEN)], dtype=np.uint8)
    return out


def _build_crc_matrix() -> np.ndarray:
    m = np.zeros((CRC_LEN, MSG_LEN), dtype=np.uint8)
    for j in range(MSG_LEN):
        e = np.zeros(MSG_LEN, dtype=np.uint8)
        e[j] = 1
        m[:, j] = crc13_bits(e)
    return m


CRC_MATRIX = _build_crc_matrix()


def crc13_matrix(bits77: np.ndarray) -> np.ndarray:
    """CRC via the GF(2) matrix; bits77 may be (..., 77)."""
    b = np.asarray(bits77, dtype=np.uint8)
    return (b @ CRC_MATRIX.T) % 2


def attach_crc(bits77: np.ndarray) -> np.ndarray:
    """77 message bits -> 90 info bits (message + CRC13)."""
    return np.concatenate([np.asarray(bits77, dtype=np.uint8), crc13_bits(bits77)])


def check_crc(info90: np.ndarray) -> bool:
    info90 = np.asarray(info90, dtype=np.uint8)
    return bool((crc13_bits(info90[:MSG_LEN]) == info90[MSG_LEN : MSG_LEN + CRC_LEN]).all())
