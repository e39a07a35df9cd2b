"""Wideband sync scan: the plain torch version and the kernel B1 wrapper.

Port of msk144cudecoder_tpu/ops/scan.py (math) and the kernel
ops/pallas_scan.py::_scan_kernel (the scan the main path runs). With
z_f(t) = c(t) exp(-2j pi f (t mod N) / fs), every averaging pattern's sync
metric derives from one per-frequency correlation field

    G_f(l) = E_f(l) * sum_i conj(c((l+i) mod N)) * B[i, f]
             (taps with l+i >= N additionally scaled by 1 + chi_f)
    s_p(f, l) = sum_{m in mask_p} G_f(l + 864m) + G_f(l + 864m + 336)

(all lags mod N). Every roll amount is divisible by dec, so on the coarse
grid l = dec*l' the field is exact at its lags. Candidate selection keeps the
best lag of each of 21 slices of 256 lags (the head wraps), smallest lag
winning ties, then the top-k slices per (f, p), smallest slice index winning
ties. Positions are canonical mod N.

With fast=True (DecoderConfig.fast_math) the correlation takes the JAX
kernel's fast form (ops/precision.py, B1): bf16 lag planes and B operands,
three float32-accumulated products in the Karatsuba combination, which
kernel B1's bf16 instantiation computes on the tensor cores.

`scan` dispatches on the device of its input: a CUDA tensor goes to the
hand-written kernel (csrc/scan.cu) or raises; a CPU tensor runs the plain
version. There is no fallback between the two.
"""

from __future__ import annotations

import torch

from .. import constants as C

from . import kernels
from .precision import round_bf16

_N = C.WINDOW_LEN
_TAPS = C.SYNC_CORR_LEN


def _check_dec(dec: int) -> int:
    if dec not in (1, 2, 4):
        raise ValueError(f"dec must be 1, 2 or 4, got {dec}")
    return _N // dec


def karatsuba_bf16(x: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """conj(x) @ B in the fast form: x (..., 42) and B (42, F) complex64 as
    bf16 planes [xr, xi, xr - xi] and [br, bi, br + bi], three float32
    products m1, m2, m3; re = m1 + m2, im = m3 - m1 + m2."""
    xr, xi = x.real, x.imag
    br, bi = B.real, B.imag
    m1 = torch.matmul(round_bf16(xr), round_bf16(br))
    m2 = torch.matmul(round_bf16(xi), round_bf16(bi))
    m3 = torch.matmul(round_bf16(xr - xi), round_bf16(br + bi))
    return torch.complex(m1 + m2, m3 - m1 + m2)


def sync_correlation(c: torch.Tensor, B: torch.Tensor, E_dec: torch.Tensor,
                     chi: torch.Tensor, dec: int = 1, fast: bool = False) -> torch.Tensor:
    """G (..., N/dec, F) complex64 on the coarse lag grid.

    c (..., N) complex64; B (42, F); E_dec (F, N/dec) (tables.e_decimated);
    chi (F,). fast: the correlation and its wrap correction in the bf16
    Karatsuba form (karatsuba_bf16)."""
    n2 = _check_dec(dec)
    dev = c.device
    corr = karatsuba_bf16 if fast else (lambda x, b: torch.matmul(x.conj(), b))
    lags = torch.arange(0, _N, dec, device=dev)
    taps = torch.arange(_TAPS, device=dev)
    ext = torch.cat([c, c[..., : _TAPS - 1]], dim=-1)
    cmat = ext[..., lags[:, None] + taps[None, :]]  # (..., n2, 42)
    R = corr(cmat, B)  # (..., n2, F)
    # wrapped taps of the last lags pick up the (1 + chi) mixing factor
    nt = int((lags >= _N - (_TAPS - 1)).sum())
    lt = lags[n2 - nt:]
    wrapped = (lt[:, None] + taps[None, :]) >= _N
    bidx = torch.where(wrapped, lt[:, None] + taps[None, :] - _N, 0)
    bnd = torch.where(wrapped, c[..., bidx], torch.zeros((), dtype=c.dtype, device=dev))
    D = corr(bnd, B)  # (..., nt, F)
    R = torch.cat([R[..., : n2 - nt, :], R[..., n2 - nt:, :] + chi * D], dim=-2)
    return E_dec.transpose(0, 1) * R


def pattern_metrics(G: torch.Tensor, scan_depth: int, dec: int = 1) -> torch.Tensor:
    """xb (..., P, N/dec, F) float32: |s_p| for the first scan_depth patterns
    (patterns 0-5 are prefix sums over frames, 6 and 7 the gap masks)."""
    def roll(a: int) -> torch.Tensor:
        return torch.roll(G, -(a // dec), dims=-2)

    T = [roll(864 * m) + roll(864 * m + C.SECOND_SYNC_SAMPLE)
         for m in range(C.PATTERN_LEN)]
    S = [T[0]]
    for m in range(1, 6):
        S.append(S[-1] + T[m])
    S.append(T[0] + T[3])  # pattern 6: 100100
    S.append(T[0] + T[3] + T[4])  # pattern 7: 100110
    return torch.abs(torch.stack(S[:scan_depth], dim=-3)).to(torch.float32)


def select_candidates(xb: torch.Tensor, num_cand: int = C.NUM_CANDIDATES_PER_PATTERN,
                      dec: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """xb (..., P, N/dec, F) coarse-grid metric -> (pos int32, xb_top f32),
    each (..., F, P, k): best lag per 256-lag slice (argmax-first), then the
    top-k slices in descending xb order (lower slice index first on ties)."""
    n2 = _check_dec(dec)
    slice2 = C.SCAN_SLICE // dec
    pad2 = C.NUM_SCAN_SLICES * slice2
    xbp = torch.cat([xb, xb[..., : pad2 - n2, :]], dim=-2)
    sl = xbp.reshape(xb.shape[:-2] + (C.NUM_SCAN_SLICES, slice2, xb.shape[-1]))
    smax = sl.amax(dim=-2)  # (..., P, 21, F)
    lag = torch.arange(slice2, device=xb.device)[:, None]
    sarg = torch.where(sl == smax.unsqueeze(-2), lag, slice2).amin(dim=-2)
    sm = smax.movedim(-1, -3)  # (..., F, P, 21)
    sa = sarg.movedim(-1, -3)
    vals, order = torch.sort(sm, dim=-1, descending=True, stable=True)
    top = order[..., :num_cand]
    pos = (top * C.SCAN_SLICE + dec * torch.gather(sa, -1, top)) % _N
    return pos.to(torch.int32), vals[..., :num_cand].contiguous()


def scan_plain(c: torch.Tensor, B: torch.Tensor, E_dec: torch.Tensor,
               chi: torch.Tensor, scan_depth: int,
               num_cand: int = C.NUM_CANDIDATES_PER_PATTERN,
               dec: int = 1, fast: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch scan of windows c (..., N) -> (pos, xb) each (..., F, P, k)."""
    G = sync_correlation(c, B, E_dec, chi, dec, fast)
    return select_candidates(pattern_metrics(G, scan_depth, dec), num_cand, dec)


FREQ_TILES = (4, 2, 1)  # frequencies per block of kernel B1, widest first


def scan_tile(n_win: int, F: int, dec: int, num_sms: int) -> int:
    """Frequencies per block of kernel B1: the widest tile of at most dec
    (G of the tile takes the window's place in shared memory) whose grid of
    n_win * ceil(F / tile) blocks still gives every SM one, else 1."""
    _check_dec(dec)
    for ft in FREQ_TILES[:-1]:
        if ft <= dec and n_win * -(-F // ft) >= num_sms:
            return ft
    return FREQ_TILES[-1]


SMEM_NO_OPT_IN = 48 * 1024  # bytes a block may use without an opt-in
SMEM_OPT_IN_MAX = 232_448  # bytes a block may use after one, on the H100


def scan_smem_bytes(freq_tile: int, dec: int, scan_depth: int) -> int:
    """Kernel B1's dynamic shared memory (smem_bytes in csrc/scan.cu, which
    asserts the same bound at compile time): the staged window, whose place
    G of the tile's frequencies takes (freq_tile * N/dec <= N entries), their
    42 taps, and the value and lag of 21 slice maxima per frequency and
    pattern. The kernel launches without a shared-memory opt-in, so every
    tile must stay within SMEM_NO_OPT_IN."""
    n2 = _check_dec(dec)
    if freq_tile * n2 > _N:
        raise ValueError(f"a tile of {freq_tile} frequencies does not fit at dec {dec}")
    return 8 * (_N + _TAPS * freq_tile + freq_tile * scan_depth * C.NUM_SCAN_SLICES)


FAST_TAPS = 48  # the product's K: the 42 taps and 6 zero taps
FAST_PLANES_BYTES = 3 * 2 * (_N + FAST_TAPS)  # bf16 planes cr, ci, cd, extended


def scan_fast_smem_bytes(freq_tile: int, dec: int) -> int:
    """The dynamic shared memory of kernel B1's bf16 instantiation
    (fast_smem_bytes in csrc/scan.cu), on the float32 kernel's tiles
    (scan_tile): G of the tile's frequencies beside the window's bf16
    planes, whose place the slice maxima take later (at any depth). Above
    SMEM_NO_OPT_IN, so the kernel launches with an opt-in, and within
    SMEM_OPT_IN_MAX."""
    n2 = _check_dec(dec)
    if freq_tile not in FREQ_TILES or freq_tile * n2 > _N:
        raise ValueError(f"a tile of {freq_tile} frequencies does not fit at dec {dec}")
    return 8 * freq_tile * n2 + FAST_PLANES_BYTES


def scan_cuda(c: torch.Tensor, B: torch.Tensor, E_dec: torch.Tensor,
              chi: torch.Tensor, scan_depth: int,
              num_cand: int = C.NUM_CANDIDATES_PER_PATTERN,
              dec: int = 1, fast: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B1 (csrc/scan.cu) on windows c (Bw, N) -> (pos, xb) each
    (Bw, F, P, k); fast launches its bf16 instantiation, the correlation on
    the tensor cores. Every input must be a contiguous complex64 CUDA tensor
    on one device. The kernel stages each window with 16-byte loads, so a c
    that does not start on a 16-byte boundary (a view into a larger tensor)
    is copied first."""
    n2 = _check_dec(dec)
    F = B.shape[-1]
    kernels.check_tensors("scan", c=(c, torch.complex64, (-1, _N)),
                          B=(B, torch.complex64, (_TAPS, F)),
                          E_dec=(E_dec, torch.complex64, (F, n2)),
                          chi=(chi, torch.complex64, (F,)))
    if not 1 <= scan_depth <= C.SCAN_DEPTH_MAX:
        raise ValueError(f"scan_depth must be in [1, 8], got {scan_depth}")
    if not 1 <= num_cand <= C.NUM_CANDIDATES_PER_PATTERN:
        raise ValueError(f"num_cand must be in [1, 8], got {num_cand}")
    nw = c.shape[0]
    pos = torch.empty((nw, F, scan_depth, num_cand), dtype=torch.int32, device=c.device)
    xb = torch.empty((nw, F, scan_depth, num_cand), dtype=torch.float32, device=c.device)
    if nw and F:
        lib = kernels.library()
        if c.data_ptr() % 16:
            c = c.clone()
        ft = scan_tile(nw, F, dec, kernels.num_sms(c.device))
        with torch.cuda.device(c.device):
            rc = lib.msk_scan(c.data_ptr(), B.data_ptr(), E_dec.data_ptr(),
                              chi.data_ptr(), pos.data_ptr(), xb.data_ptr(),
                              nw, F, scan_depth, num_cand, dec, ft, int(fast),
                              kernels.stream_ptr(c.device))
        kernels.raise_on_error("msk_scan", rc)
        kernels.count_launch(scan_cuda, fast)
    return pos, xb


scan_cuda.launches = 0
scan_cuda.launches_fast = 0


def scan(c: torch.Tensor, B: torch.Tensor, E_dec: torch.Tensor,
         chi: torch.Tensor, scan_depth: int,
         num_cand: int = C.NUM_CANDIDATES_PER_PATTERN,
         dec: int = 1, fast: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Scan windows c (Bw, N): kernel B1 on a CUDA tensor, plain on the CPU."""
    if kernels.on_cuda(c):
        return scan_cuda(c, B, E_dec, chi, scan_depth, num_cand, dec, fast)
    return scan_plain(c, B, E_dec, chi, scan_depth, num_cand, dec, fast)
