"""Synthetic MSK144 stimuli for checks and measurements (numpy only).

The same waveforms, bit for bit, as the JAX package's golden model
(msk144cudecoder_tpu/golden/model.py: frame_bits_from_message,
modulate_frame, synthesize_baseband, synthesize_audio_int16,
synthesize_iq_int8), its busy-band battery (tests/test_busyband.py) and its
streaming soak (tests/test_soak.py), so that this package can make its own
inputs without importing the JAX package. Every function draws its noise
from the numpy Generator it is given, or from the seed it is given.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from . import constants as C
from .protocol import crc, ldpc_tables, msg77

# complex-noise sigma for unit real noise power in 2500 Hz (WSJT SNR convention)
NOISE_SIGMA = np.sqrt(0.5 * (C.SAMPLE_RATE / 2) / 2500.0) * np.sqrt(2.0)

# the busy-band pileup: (text, f0_hz, snr_db, start_frame, num_frames); four
# staggered pings, every consecutive pair overlapping in time
BUSY_BAND_PINGS = [
    ("CQ K1ABC FN42", 1420.0, 7.0, 0, 5),
    ("K1ABC W9XYZ EN37", 1560.0, 3.0, 4, 5),
    ("W9XYZ K1ABC R-03", 1470.0, 1.0, 8, 5),
    ("CQ N0XYZ DM79", 1580.0, 5.0, 12, 5),
]
BUSY_BAND_FRAMES = 21

# the streaming soak: (text, f0_hz, snr_db, start_sample, num_frames) over
# SOAK_WINDOWS windows (~24 s). The second burst starts mid-hop, so no
# window holds its head aligned (the straddle case); the third is weak and
# long, for the deeper averaging patterns
SOAK_WINDOWS = 110
SOAK_BURSTS = [
    ("CQ K1ABC FN42", 1500.0, 8.0, 10 * C.HOP_LEN, 12),
    ("K1ABC W9XYZ R-02", 1460.0, 3.0, 40 * C.HOP_LEN + 1300, 12),
    ("W9XYZ K1ABC RR73", 1540.0, -2.0, 80 * C.HOP_LEN, 18),
]


def frame_bits_from_message(text: str) -> np.ndarray:
    """Message text -> 144 channel bits (sync words + LDPC codeword)."""
    cw = ldpc_tables.encode(crc.attach_crc(msg77.pack77(text)))
    frame = np.zeros(C.NUM_CHANNEL_BITS, dtype=np.uint8)
    frame[0:8] = C.SYNC_WORD
    frame[8:56] = cw[0:48]
    frame[56:64] = C.SYNC_WORD
    frame[64:144] = cw[48:128]
    return frame


def modulate_frame(bits144: np.ndarray) -> np.ndarray:
    """144 channel bits -> one 864-sample complex MSK baseband frame: even
    bits on the Q rail (half-sine over [12q-6, 12q+6) cyclically), odd bits
    on the I rail (over [12p, 12p+12))."""
    s = 2.0 * np.asarray(bits144, dtype=np.float64) - 1.0
    i_rail = np.zeros(C.FRAME_LEN)
    q_rail = np.zeros(C.FRAME_LEN)
    for p in range(72):
        i_rail[(12 * p + np.arange(12)) % C.FRAME_LEN] += s[2 * p + 1] * C.PP12
        q_rail[(12 * p - 6 + np.arange(12)) % C.FRAME_LEN] += s[2 * p] * C.PP12
    return i_rail + 1j * q_rail


def _to_int16(sig: np.ndarray) -> np.ndarray:
    return np.clip(np.round(sig.real * 1000.0), -32768, 32767).astype(np.int16)


def synthesize_baseband(messages: Sequence[Tuple[str, float]], num_frames: int,
                        snr_db: Optional[float] = None,
                        rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Complex baseband at 12 kS/s: the messages (text, f0_hz) repeated over
    num_frames frames, in complex noise at snr_db (signal power over the
    noise power in 2500 Hz) when given."""
    rng = rng or np.random.default_rng(0)
    n = num_frames * C.FRAME_LEN
    t = np.arange(n)
    sig = np.zeros(n, dtype=np.complex128)
    for text, f0 in messages:
        bb = np.tile(modulate_frame(frame_bits_from_message(text)), num_frames)
        sig += bb * np.exp(2j * np.pi * f0 * t / C.SAMPLE_RATE)
    if snr_db is not None:
        amp = np.sqrt(2.0 * 10 ** (snr_db / 10.0))
        sig = amp * sig + NOISE_SIGMA * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return sig


def synthesize_audio_int16(messages: Sequence[Tuple[str, float]], num_frames: int,
                           snr_db: Optional[float] = None,
                           rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """16-bit mono audio at 12 kS/s (read mode 1) of synthesize_baseband."""
    return _to_int16(synthesize_baseband(messages, num_frames, snr_db, rng))


def synthesize_iq_int8(messages: Sequence[Tuple[str, float]], num_frames: int,
                       snr_db: Optional[float] = None,
                       rng: Optional[np.random.Generator] = None,
                       scale: float = 24.0) -> np.ndarray:
    """Interleaved signed 8-bit I/Q at 12 kS/s (read mode 2) of
    synthesize_baseband."""
    bb = synthesize_baseband(messages, num_frames, snr_db, rng)
    iq = np.empty(2 * bb.size, dtype=np.int8)
    iq[0::2] = np.clip(np.round(bb.real * scale), -128, 127).astype(np.int8)
    iq[1::2] = np.clip(np.round(bb.imag * scale), -128, 127).astype(np.int8)
    return iq


def _add_bursts(sig: np.ndarray, bursts) -> None:
    """Add each (text, f0_hz, snr_db, start_sample, num_frames) burst into
    sig in place, at its own SNR over [start, start + frames * 864)."""
    t = np.arange(sig.size)
    for text, f0, snr, start, frames in bursts:
        bb = np.tile(modulate_frame(frame_bits_from_message(text)), frames)
        amp = np.sqrt(2.0 * 10 ** (snr / 10.0))
        seg = slice(start, start + bb.size)
        sig[seg] += amp * bb * np.exp(2j * np.pi * f0 * t[seg] / C.SAMPLE_RATE)


def busy_band_audio(seed: int = 101) -> np.ndarray:
    """16-bit audio of the four staggered BUSY_BAND_PINGS over one noise
    floor, each ping at its own SNR and time span."""
    rng = np.random.default_rng(seed)
    n = BUSY_BAND_FRAMES * C.FRAME_LEN
    sig = np.zeros(n, dtype=np.complex128)
    _add_bursts(sig, [(text, f0, snr, start * C.FRAME_LEN, frames)
                      for text, f0, snr, start, frames in BUSY_BAND_PINGS])
    sig += NOISE_SIGMA * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return _to_int16(sig)


def soak_audio(seed: int = 1234) -> np.ndarray:
    """16-bit audio of the streaming soak: SOAK_WINDOWS windows of noise
    with the SOAK_BURSTS in it."""
    rng = np.random.default_rng(seed)
    n = C.WINDOW_LEN + (SOAK_WINDOWS - 1) * C.HOP_LEN
    sig = NOISE_SIGMA * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    _add_bursts(sig, SOAK_BURSTS)
    return _to_int16(sig)


def stream_windows(audio: np.ndarray) -> np.ndarray:
    """(B, N) batch of a stream's 50%-overlap windows."""
    starts = range(0, len(audio) - C.WINDOW_LEN + 1, C.HOP_LEN)
    return np.stack([audio[s:s + C.WINDOW_LEN] for s in starts])
