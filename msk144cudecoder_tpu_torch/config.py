"""Typed decoder configuration of the PyTorch port.

The same fields, defaults and validation as the JAX package's
msk144cudecoder_tpu/config.py, so that a configuration means the same decode
in both packages (the tests build one of each from the same keywords). It is
frozen and hashable. Two fields differ in effect here:

  use_pallas   absent: the port's kernels run whenever the tensors lie on a
               CUDA device, and their plain torch versions on the CPU.
  fast_math    accepted for flag compatibility and ignored: the port computes
               in float32 throughout (TF32 off). A reduced-precision mode
               would need its own decode validation.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from . import constants as C


@dataclass(frozen=True)
class DecoderConfig:
    # --- CLI-equivalent options of the reference decoder ---
    center_frequency: float = 1500.0
    search_step: float = 2.0
    search_width: float = 200.0
    scan_depth: int = 4
    read_mode: int = 1  # 1 = 16-bit audio, 2 = 8-bit IQ
    analytic_method: int = 2  # 1 = FFT Hilbert, 2 = shift+FIR+shift
    nbadsync_threshold: int = 1

    # --- Decoder knobs (no reference equivalent) ---
    max_survivors: int = 256  # K: LDPC rows per window, the best survivors
    # by (nbadsync, xb) under per-pattern quotas; stands in for the
    # reference's dynamic stream compaction
    max_results: int = 64  # result slots returned per window (decodes first)
    candidates_per_pattern: int = 8  # top-k candidate lags per (freq, pattern)
    survivor_prefilter: int | None = None  # demodulate only the top-P
    # candidates by scan xb. None = auto = 2 * max_survivors; 0 = demodulate
    # every candidate (needs the full-demod kernel, not yet in this port)
    prefilter_per_cell: int = 2  # cap on prefiltered candidates per (freq,
    # pattern) cell; >= 2 keeps two same-frequency transmissions alive
    fast_math: bool = True  # ignored by the port (float32 throughout)
    window_batch: int = 1  # windows decoded per device call
    scan_decimation: int = 4  # the sync scan correlates every dec-th lag
    # (dec in {1, 2, 4}); every roll of the pattern combine is divisible by
    # 4, so the decimated field is exact at its lags. 1 = the reference's
    # full per-lag grid

    def __post_init__(self):
        d = min(max(self.scan_depth, 1), C.SCAN_DEPTH_MAX)
        object.__setattr__(self, "scan_depth", d)
        if self.read_mode not in (1, 2):
            raise ValueError(f"read_mode must be 1 or 2, got {self.read_mode}")
        if self.analytic_method not in (1, 2):
            raise ValueError(f"analytic_method must be 1 or 2, got {self.analytic_method}")
        if not 1 <= self.candidates_per_pattern <= C.NUM_CANDIDATES_PER_PATTERN:
            raise ValueError(
                f"candidates_per_pattern must be in [1, {C.NUM_CANDIDATES_PER_PATTERN}],"
                f" got {self.candidates_per_pattern}")
        if not 1 <= self.prefilter_per_cell <= C.NUM_CANDIDATES_PER_PATTERN:
            raise ValueError(
                f"prefilter_per_cell must be in [1, {C.NUM_CANDIDATES_PER_PATTERN}],"
                f" got {self.prefilter_per_cell}")
        if self.scan_decimation not in (1, 2, 4):
            raise ValueError(
                f"scan_decimation must be 1, 2 or 4, got {self.scan_decimation}")

    @classmethod
    def create(cls, **kwargs) -> "DecoderConfig":
        """Create with the reference's default center frequency per read mode:
        1500 Hz for audio, 0 Hz for IQ."""
        if "center_frequency" not in kwargs:
            kwargs["center_frequency"] = 0.0 if kwargs.get("read_mode", 1) == 2 else 1500.0
        return cls(**kwargs)

    def replace(self, **kwargs) -> "DecoderConfig":
        return dataclasses.replace(self, **kwargs)

    @property
    def freqs(self) -> np.ndarray:
        return C.freq_grid(self.center_frequency, self.search_width, self.search_step)

    @property
    def num_freqs(self) -> int:
        return len(self.freqs)

    @property
    def num_candidates(self) -> int:
        return self.num_freqs * self.scan_depth * self.candidates_per_pattern

    @property
    def left_bound(self) -> float:
        return float(self.freqs[0])

    @property
    def right_bound(self) -> float:
        return float(self.freqs[-1])
