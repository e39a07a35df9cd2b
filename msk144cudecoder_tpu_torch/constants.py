"""MSK144 protocol numerology and decoder geometry constants.

Behavioral spec mirrors the reference decoder's constants
(reference src/common.h:14-47 and src/msk_context.cuh:147-154,229-255),
shared by the JAX package and this port (a copy of its constants.py): no thread
counts here, only protocol facts and search-grid geometry.
"""

from __future__ import annotations

import numpy as np

# --- Sample/frame geometry (common.h:14-24,47) ---
SAMPLE_RATE = 12000.0  # samples per second
FRAME_LEN = 864  # samples per MSK144 frame (72 ms, 144 channel bits x 6 samp/bit)
NUM_FRAMES = 6  # frames in the sliding analysis window
WINDOW_LEN = NUM_FRAMES * FRAME_LEN  # 5184 samples = 432 ms
HOP_LEN = WINDOW_LEN // 2  # 2592 new samples consumed per loop (50% overlap)
SAMPLES_PER_BIT = 6

# --- Channel-bit layout within one 144-bit frame ---
SYNC_LEN_BITS = 8
SYNC_WORD = np.array([0, 1, 1, 1, 0, 0, 1, 0], dtype=np.int8)  # msk_context.cuh:149
SYNC_WORD_PM = (2 * SYNC_WORD - 1).astype(np.int8)  # +-1 form
NUM_CHANNEL_BITS = 144
NUM_DATA_BITS = 128  # LDPC(128,90) codeword bits per frame
NUM_MESSAGE_BITS = 77
NUM_CRC_BITS = 13
NUM_INFO_BITS = NUM_MESSAGE_BITS + NUM_CRC_BITS  # 90
NUM_PARITY_BITS = NUM_DATA_BITS - NUM_INFO_BITS  # 38

# First sync word occupies channel bits [0..8); first data chunk bits [8..56);
# second sync word bits [56..64); second data chunk bits [64..144).
FIRST_SYNC_BIT = 0
SECOND_SYNC_BIT = 56
DATA_BITS_A = (8, 56)  # codeword bits [0..48)
DATA_BITS_B = (64, 144)  # codeword bits [48..128)

# Sample offsets of the two 42-sample sync correlation regions (common.h:19-20)
SYNC_CORR_LEN = 42
FIRST_SYNC_SAMPLE = 0
SECOND_SYNC_SAMPLE = (8 + 48) * SAMPLES_PER_BIT  # 336

# --- Demod / LDPC parameters ---
NUM_BP_ITERATIONS = 10  # common.h:29
MAX_HARD_ERRORS = 18  # ldpc_kernel.cuh:203-209 (accept decode only if < 18)
SOFTBIT_SIGMA = 0.60  # softbits_kernel.cuh:200
CRC13_POLY = 0x15D7  # ldpc_context.cuh:7

# --- Search-grid / candidate geometry ---
NUM_CANDIDATES_PER_PATTERN = 8  # common.h:34
SCAN_DEPTH_MAX = 8
PATTERN_LEN = 6  # frames per averaging mask
# Scan slices: the reference sweeps lags in 21 slices of 256 and keeps the best
# lag per slice before top-k selection (scan_kernel.cuh:85-89). We reproduce the
# same slicing so candidate sets match.
SCAN_SLICE = 256
NUM_SCAN_SLICES = -(-WINDOW_LEN // SCAN_SLICE)  # 21 (last slice wraps)
SCAN_PAD_LEN = NUM_SCAN_SLICES * SCAN_SLICE  # 5376

# Averaging patterns: which of the 6 window frames are coherently summed
# (msk_context.cuh:231-240). Row i is scan-depth level i+1.
PATTERN_MASKS = np.array(
    [
        [1, 0, 0, 0, 0, 0],
        [1, 1, 0, 0, 0, 0],
        [1, 1, 1, 0, 0, 0],
        [1, 1, 1, 1, 0, 0],
        [1, 1, 1, 1, 1, 0],
        [1, 1, 1, 1, 1, 1],
        [1, 0, 0, 1, 0, 0],
        [1, 0, 0, 1, 1, 0],
    ],
    dtype=np.int8,
)
PATTERN_NUM_AVG = PATTERN_MASKS.sum(axis=1).astype(np.int32)

# --- Half-sine MSK chip pulse: sin(i*pi/12), i in [0,12) (msk_context.cuh:137-145)
PP12 = np.sin(np.arange(12) * np.pi / 12.0).astype(np.float64)


def make_sync_template() -> np.ndarray:
    """42-sample complex sync-correlation template (msk_context.cuh:176-197).

    The template is the ideal MSK baseband waveform of the 8-bit sync word:
    even sync bits ride the Q (imag) rail, odd bits the I (real) rail, each as
    a 12-sample half-sine (the first Q pulse enters mid-pulse, the last I pulse
    exits mid-pulse, trimming the span to 42 samples).
    """
    s8 = SYNC_WORD_PM.astype(np.float64)
    pp = PP12
    cbi = np.zeros(42)
    cbq = np.zeros(42)
    cbq[0:6] = pp[6:12] * s8[0]
    cbq[6:18] = pp * s8[2]
    cbq[18:30] = pp * s8[4]
    cbq[30:42] = pp * s8[6]
    cbi[0:12] = pp * s8[1]
    cbi[12:24] = pp * s8[3]
    cbi[24:36] = pp * s8[5]
    cbi[36:42] = pp[0:6] * s8[7]
    return cbi + 1j * cbq


CB42 = make_sync_template()


def freq_grid(center_freq: float, search_width: float, search_step: float) -> np.ndarray:
    """Frequency channels searched, matching msk_context.cuh:95-113 geometry."""
    assert search_step > 0
    half_len = int((search_width / 2) / search_step)
    n = 2 * half_len + 1
    f_lo = center_freq - half_len * search_step
    return (f_lo + np.arange(n) * search_step).astype(np.float64)


# --- Analytic-signal preprocessing (analytic2.cuh / analytic_fft.cu) ---
FIR_PAD = 32  # zero-pad head/tail samples around the window (analytic2.cuh:241)
# 15-tap half-band boxcar-windowed LPF, cutoff 0.2*Nyquist, taps with
# |h|<=1e-4 zeroed (analytic2.cuh:123-159). Regenerated, not transcribed:
# scipy.signal.firwin(15, 0.2, window='boxcar') equals sinc sampling below.
def _make_halfband_fir() -> np.ndarray:
    n = np.arange(15) - 7.0
    h = np.sinc(0.2 * n) * 0.2
    h = h / h.sum()  # firwin normalizes DC gain to 1
    h[np.abs(h) <= 1e-4] = 0.0
    return h


FIR15 = _make_halfband_fir()

ANALYTIC_NFFT = 8192  # analytic_fft.cu plan size
ANALYTIC_BPF_CENTER = 1500.0
ANALYTIC_BPF_WIDTH = 2000.0
ANALYTIC_BPF_BETA = 0.1

# Real-time soft budget per working-loop iteration (main.cu:398-403)
LOOP_SOFT_BUDGET_MS = 210.0
