"""Analytic-signal preprocessing as batched torch ops.

Port of msk144cudecoder_tpu/ops/analytic.py (same arithmetic, same order):
  method 2  shift -fs/8, 15-tap half-band FIR applied twice (second pass
            time-reversed for zero phase), shift +fs/8, 32-sample zero halo
  method 1  8192-point FFT Hilbert transform with a raised-cosine band filter
  IQ LPF    FIR-only path for 8-bit IQ input

All ops take (..., 5184) batches on any device and return contiguous
tensors (the kernels take no strided input). The FIR is 13 shifted adds
(taps with |h| <= 1e-4 are zero); no kernel is needed at this size.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import constants as C

_PAD = C.FIR_PAD
_N = C.WINDOW_LEN
_TOTAL = _N + 2 * _PAD


def _fir_taps() -> list[tuple[int, float]]:
    return [(k, float(h)) for k, h in enumerate(C.FIR15) if h != 0.0]


def _fir_forward(x: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_k h[k] * x[i+15-k] for i in [0, n-32); tail unchanged."""
    m = x.shape[-1] - 32
    acc = torch.zeros_like(x[..., :m])
    for k, h in _fir_taps():
        acc = acc + h * x[..., 15 - k : 15 - k + m]
    return torch.cat([acc, x[..., m:]], dim=-1)


def _fir_backward(x: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_k h[k] * x[i-15+k] for i in [32, n); head unchanged."""
    m = x.shape[-1] - 32
    acc = torch.zeros_like(x[..., :m])
    for k, h in _fir_taps():
        acc = acc + h * x[..., 17 + k : 17 + k + m]
    return torch.cat([x[..., :32], acc], dim=-1)


@functools.lru_cache(maxsize=None)
def shift_tables() -> tuple[np.ndarray, np.ndarray]:
    """(left, right) complex64 (N + 64,) fs/8 shift carriers."""
    n = np.arange(_TOTAL)
    left = np.exp(-2j * np.pi * (n + 1) / 8.0).astype(np.complex64)
    right = np.exp(2j * np.pi * n / 8.0).astype(np.complex64)
    return left, right


def _pad(x: torch.Tensor) -> torch.Tensor:
    z = torch.zeros(x.shape[:-1] + (_PAD,), dtype=x.dtype, device=x.device)
    return torch.cat([z, x, z], dim=-1)


def _shift(device) -> tuple[torch.Tensor, torch.Tensor]:
    left, right = shift_tables()
    return (torch.from_numpy(left).to(device), torch.from_numpy(right).to(device))


def analytic_method2(x: torch.Tensor, shifts=None) -> torch.Tensor:
    """Real (..., 5184) normalized samples -> complex64 analytic signal.
    `shifts`: the (left, right) carriers on x's device (built if None)."""
    left, right = shifts if shifts is not None else _shift(x.device)
    z = _pad(x.to(torch.float32)).to(torch.complex64)
    z = z * left
    z = _fir_backward(_fir_forward(z))
    z = z * right
    return z[..., _PAD : _PAD + _N].contiguous()


def iq_filter(z: torch.Tensor) -> torch.Tensor:
    """Complex (..., 5184) IQ samples -> low-pass filtered (read mode 2)."""
    z = _pad(z.to(torch.complex64))
    z = _fir_backward(_fir_forward(z))
    return z[..., _PAD : _PAD + _N].contiguous()


@functools.lru_cache(maxsize=None)
def bpf_half() -> np.ndarray:
    """(8192,) float32 spectrum mask of analytic method 1."""
    nfft = C.ANALYTIC_NFFT
    df = C.SAMPLE_RATE / nfft
    f = np.arange(nfft // 2) * df - C.ANALYTIC_BPF_CENTER
    t = 1.0 / C.ANALYTIC_BPF_WIDTH
    beta = C.ANALYTIC_BPF_BETA
    lo = (1 - beta) / (2 * t)
    hi = (1 + beta) / (2 * t)
    h = np.ones(nfft // 2)
    af = np.abs(f)
    trans = (af > lo) & (af <= hi)
    h[trans] = 0.5 * (1.0 + np.cos((np.pi * t / beta) * (af[trans] - lo)))
    h[af > hi] = 0.0
    full = np.zeros(nfft)
    full[: nfft // 2] = h
    full[0] *= 0.5
    return full.astype(np.float32)


def analytic_method1(x: torch.Tensor, bpf: torch.Tensor | None = None) -> torch.Tensor:
    """Real (..., 5184) samples -> analytic signal via a zero-padded
    8192-point FFT; the unnormalized inverse is ifft * nfft."""
    nfft = C.ANALYTIC_NFFT
    if bpf is None:
        bpf = torch.from_numpy(bpf_half()).to(x.device)
    xx = x.to(torch.float32) * (2.0 / nfft)
    xx = torch.cat([xx, torch.zeros(x.shape[:-1] + (nfft - _N,), dtype=xx.dtype,
                                    device=xx.device)], dim=-1)
    X = torch.fft.fft(xx.to(torch.complex64), dim=-1)
    X = X * bpf
    out = torch.fft.ifft(X, dim=-1) * nfft
    return out[..., :_N].to(torch.complex64).contiguous()


def rms_normalize(x: torch.Tensor) -> torch.Tensor:
    """fac = 1/rms over each window."""
    x = x.to(torch.float32)
    rms = torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True))
    return x / torch.clamp_min(rms, 1e-30)
