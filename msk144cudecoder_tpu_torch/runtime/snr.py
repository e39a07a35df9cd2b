"""SNR tracker: asymmetric-EMA noise floor over 8 sub-block powers.

Behavioral mirror of reference src/snr_tracker.cu:21-66: each 5184-sample
analytic window is split into 8 power sub-blocks; the noise floor rises slowly
(0.9/0.1 EMA) and falls instantly; SNR = 10*log10(peak/noise - 1) clamped to
[-8, +24] dB. The per-block powers are computed on-device inside the decode
pipeline (ops.pipeline.block_powers) so only 8 floats cross to the host.
"""

from __future__ import annotations

import math

import numpy as np


class SNRTracker:
    def __init__(self) -> None:
        self._noise_power = 0.0
        self._snr = 0.0

    def process_powers(self, block_power: np.ndarray) -> None:
        """Update from the 8 sub-block powers of one window (device-computed)."""
        arr = np.asarray(block_power, dtype=np.float64)
        avg = float(arr.mean())
        peak = float(arr.max())

        if self._noise_power <= 0.0:
            self._noise_power = avg
        elif avg > self._noise_power:
            self._noise_power = 0.9 * self._noise_power + 0.1 * avg
        else:
            self._noise_power = avg

        if self._noise_power > 0.0:
            ratio = peak / self._noise_power - 1.0
            # log10 of a non-positive ratio is the reference's NaN path; clamp.
            self._snr = 10.0 * math.log10(ratio) if ratio > 0.0 else -8.0
        else:
            self._snr = 0.0
        self._snr = min(24.0, max(-8.0, self._snr))

    def process_data(self, data: np.ndarray) -> None:
        """Update from a raw complex window (host fallback path)."""
        n = len(data) // 8 * 8
        p = np.abs(np.asarray(data[:n])) ** 2
        self.process_powers(p.reshape(8, -1).sum(axis=-1))

    @property
    def snr_f(self) -> float:
        return self._snr

    @property
    def snr_i(self) -> int:
        return int(self._snr)  # trunc toward zero, like the C cast
