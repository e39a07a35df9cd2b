"""The traffic generator: one continuous 16-bit, 12 kS/s recording from a seed.

A traffic file (`traffic/<mix>.json`) gives the recording's length in hops
and how its MSK144 pings are drawn; this module makes the recording. Noise
is white at the WSJT convention (unit real noise power in 2500 Hz). Each
ping is a distinct standard message (two calls and a grid or a report)
repeated over its frames at its own frequency and SNR, added as the port's
stimulus module adds a burst. The number of pings and the multiset of their
lengths and SNRs depend only on the traffic file, so every seed carries the
same work: the seed draws their order, start times, frequencies and texts.

The message packer, the CRC and the LDPC encoder are the frozen copies in
`proto/`; `modulate_frame` and `frame_bits77` give the port's stimulus
waveforms bit for bit.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

from .proto import constants as C
from .proto import crc, ldpc_tables, msg77

# real noise sigma for unit noise power in 2500 Hz (WSJT SNR convention)
NOISE_SIGMA = np.sqrt(0.5 * (C.SAMPLE_RATE / 2) / 2500.0) * np.sqrt(2.0)

_LETTERS = "ABCDEFGHIJKLMNOPRSTUVWXYZ"  # no Q: a leading Q folds to 3X
_DIGITS = "0123456789"


class Ping(NamedTuple):
    text: str  # as unpack77 prints it
    f0: float
    snr_db: float
    start: int  # sample
    frames: int


class Recording(NamedTuple):
    audio: np.ndarray  # (hops * HOP_LEN,) int16, replayed circularly
    pings: List[Ping]

    @property
    def hops(self) -> int:
        return len(self.audio) // C.HOP_LEN

    def window(self, i: int) -> np.ndarray:
        """Window i of the replayed stream: samples [i, i + 2) hops, mod the
        recording's length."""
        n = len(self.audio)
        s = (i * C.HOP_LEN) % n
        if s + C.WINDOW_LEN <= n:
            return self.audio[s: s + C.WINDOW_LEN]
        return np.concatenate([self.audio[s:], self.audio[: s + C.WINDOW_LEN - n]])


def frame_bits77(bits77: np.ndarray) -> np.ndarray:
    """(n, 77) payload bits -> (n, 144) channel bits: the sync word, the
    codeword's first 48 bits, the sync word, its last 80."""
    info = np.concatenate([bits77, crc.crc13_matrix(bits77)], axis=1).astype(np.uint8)
    cw = ldpc_tables.encode(info)
    frame = np.zeros((len(bits77), C.NUM_CHANNEL_BITS), dtype=np.uint8)
    frame[:, 0:8] = C.SYNC_WORD
    frame[:, 8:56] = cw[:, 0:48]
    frame[:, 56:64] = C.SYNC_WORD
    frame[:, 64:144] = cw[:, 48:128]
    return frame


_P = np.arange(72)[:, None]
_I = np.arange(12)[None, :]
_I_RAIL = (12 * _P + _I) % C.FRAME_LEN
_Q_RAIL = (12 * _P - 6 + _I) % C.FRAME_LEN


def modulate_frame(bits144: np.ndarray) -> np.ndarray:
    """144 channel bits (or (n, 144)) -> 864-sample complex MSK baseband
    frames: even bits on the Q rail (half-sine over [12q-6, 12q+6)
    cyclically), odd bits on the I rail (over [12p, 12p+12)). The pulses of a
    rail do not overlap, so each sample is one product, as in a loop over
    the pulses."""
    s = 2.0 * np.asarray(bits144, dtype=np.float64) - 1.0
    i_rail = np.zeros(s.shape[:-1] + (C.FRAME_LEN,))
    q_rail = np.zeros(s.shape[:-1] + (C.FRAME_LEN,))
    i_rail[..., _I_RAIL] = 0.0 + s[..., 1::2, None] * C.PP12
    q_rail[..., _Q_RAIL] = 0.0 + s[..., 0::2, None] * C.PP12
    return i_rail + 1j * q_rail


def _pick(rng: np.random.Generator, alphabet: str, n: int) -> str:
    return "".join(alphabet[i] for i in rng.integers(0, len(alphabet), size=n))


def _call(rng: np.random.Generator) -> str:
    """A standard call: one or two prefix characters, a digit, 1-3 letters."""
    prefix = _pick(rng, _LETTERS, 1) + (_pick(rng, _LETTERS + _DIGITS, 1) if rng.random() < 0.5 else "")
    return prefix + _pick(rng, _DIGITS, 1) + _pick(rng, _LETTERS, int(rng.integers(1, 4)))


def _tail(rng: np.random.Generator) -> tuple[str, int]:
    """A grid, a report or a sign-off as unpack77 prints it, and its R flag."""
    u = rng.random()
    if u < 0.6:
        return _pick(rng, "ABCDEFGHIJKLMNOPQR", 2) + _pick(rng, _DIGITS, 2), 0
    if u < 0.9:
        r = int(rng.integers(-30, 33))
        ir = int(rng.random() < 0.5)
        return ("R" if ir else "") + f"{'+' if r >= 0 else '-'}{abs(r):02d}", ir
    return ("RRR", "RR73", "73")[int(rng.integers(3))], 0


def messages(rng: np.random.Generator, count: int) -> List[tuple]:
    """`count` distinct standard messages (i3 = 1: two calls and a grid or
    report), each (text as unpack77 prints it, its 77 bits)."""
    out: List[tuple] = []
    seen = set()
    while len(out) < count:
        c1, c2 = _call(rng), _call(rng)
        tail, ir = _tail(rng)
        text = f"{c1} {c2} {tail}"
        if text in seen:
            continue
        g15, ir = msg77.pack_g15(tail, ir)
        bits = msg77._compose((msg77.pack28(c1), 28), (0, 1), (msg77.pack28(c2), 28), (0, 1),
                              (ir, 1), (g15, 15), (1, 3))
        seen.add(text)
        out.append((text, bits))
    return out


def make(seed: int, traffic: dict, freqs: np.ndarray, hops: int | None = None) -> Recording:
    """The recording of a traffic file's parameters for this seed. `freqs`
    is the configuration's frequency grid (the band the pings fall in);
    `hops` overrides the file's length (the CPU checks make short ones)."""
    rng = np.random.default_rng(seed % (1 << 64))
    hops = int(traffic["hops"] if hops is None else hops)
    n = hops * C.HOP_LEN
    count = int(round(traffic["pings_per_s"] * n / C.SAMPLE_RATE))
    f_lo, f_hi = traffic["frames"]
    s_lo, s_hi = traffic["snr_db"]
    margin = traffic["freq_margin_hz"]
    frames = rng.permutation(np.resize(np.arange(f_lo, f_hi + 1), count))
    snrs = rng.permutation(s_lo + (s_hi - s_lo) * (np.arange(count) + 0.5) / max(count, 1))
    f0s = rng.uniform(freqs[0] + margin, freqs[-1] - margin, size=count)
    msgs = messages(rng, count)
    sig = NOISE_SIGMA * rng.standard_normal(n)
    base = modulate_frame(frame_bits77(np.stack([b for _, b in msgs]))) if msgs else []
    pings = []
    for (text, _), frame, nf, snr, f0 in zip(msgs, base, frames, snrs, f0s):
        length = int(nf) * C.FRAME_LEN
        start = int(rng.integers(0, n - length + 1))
        bb = np.tile(frame, int(nf))
        phase = 2 * np.pi * f0 * np.arange(start, start + length) / C.SAMPLE_RATE
        amp = np.sqrt(2.0 * 10 ** (snr / 10.0))
        # the real part of amp * bb * exp(1j * phase)
        sig[start: start + length] += amp * (bb.real * np.cos(phase) - bb.imag * np.sin(phase))
        pings.append(Ping(text, float(f0), float(snr), start, int(nf)))
    audio = np.clip(np.round(sig * 1000.0), -32768, 32767).astype(np.int16)
    return Recording(audio, sorted(pings, key=lambda p: p.start))
