"""Peaks of one NVIDIA H100 SXM and the least time of each kernel's work.

A copy of the arithmetic of `chip_smoke.py` (`bound`, `split_ops`,
`scan_bound`, `bp_bound`, its B2 and B4 counts), counted from the algorithm
at a cell's shapes, whatever kernel computes it. NVIDIA's data sheet, SXM part,
dense rates at the full 700 W: FP32 67 TFLOP/s outside the tensor cores
(BF16 there at twice that), BF16 on the tensor cores 989 TFLOP/s, HBM3 3.35
TB/s; the special-function units give 16 results per clock per SM on 132
SMs at the 1.98 GHz boost clock. A card set below 700 W runs slower than
these peaks; the run's line carries the card's power limit.
"""

from __future__ import annotations

from .proto import constants as C

PEAK_FP32 = 67e12  # FLOP/s
PEAK_BF16 = 2 * PEAK_FP32  # FLOP/s, outside the tensor cores
PEAK_BF16_TENSOR = 989e12  # FLOP/s, bf16 x bf16 products with float32 sums
PEAK_HBM = 3.35e12  # bytes/s
PEAK_SFU = 16 * 132 * 1.98e9  # special-function results/s
# the matched-filter tail of one row (B2, B4): the products of frame and taps
# (two 42-tap complex sync sums, 144 12-tap softbit dots), then the
# derotation of each tap's sample and the softbits' mean and variance
TAIL_DOT_FLOPS = 2 * 42 * 8 + 144 * 12 * 2
TAIL_F32_FLOPS = 144 * 12 * 2 + 4 * 144
BP_EDGES = 384


def bound(flops: float = 0.0, nbytes: float = 0.0, sfu: float = 0.0,
          bf16_flops: float = 0.0, tensor_flops: float = 0.0) -> tuple[float, str]:
    """The least time the card could take (ms) and what bounds it: the
    larger of the operations over their peak rate and the bytes over HBM's.
    FP32 and BF16 operations outside the tensor cores share the FMA pipes,
    so their times add; the tensor cores and the special-function units run
    beside them."""
    simt_s = flops / PEAK_FP32 + bf16_flops / PEAK_BF16
    ops_ms = max(simt_s, tensor_flops / PEAK_BF16_TENSOR, sfu / PEAK_SFU) * 1e3
    bytes_ms = nbytes / PEAK_HBM * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def split_ops(fast: bool, f32: float = 0.0, bf16: float = 0.0, dot: float = 0.0) -> dict:
    """bound()'s operation counts of work that is f32 in both modes, bf16
    arithmetic in the fast mode, and products of bf16 operands summed in
    float32 in the fast mode: all float32 in the float32 mode."""
    if not fast:
        return dict(flops=f32 + bf16 + dot)
    return dict(flops=f32, bf16_flops=bf16, tensor_flops=dot)


def scan_bound(n_win: int, F: int, depth: int, k: int, dec: int,
               fast: bool = False) -> tuple[float, str]:
    """The sync scan (kernel B1): per (window, f, coarse lag) 42 complex
    multiply-adds (in the bf16 mode three real ones of bf16 operands, as a
    tensor-core dot), the E factor, the T_m sums, the pattern sums and a
    magnitude per pattern; the windows, B, E, chi in and (pos, xb) out
    once."""
    n2 = C.WINDOW_LEN // dec
    lags = n_win * F * n2
    corr = lags * 42 * (6 if fast else 8)
    rest = lags * (6 + 2 * min(depth, 6) + 2 * depth + 4 * depth)
    nbytes = 8 * (n_win * C.WINDOW_LEN + F * (42 + n2 + 1) + n_win * F * depth * k)
    return bound(**split_ops(fast, f32=rest, dot=corr), nbytes=nbytes)


def survivor_bound(n_win: int, rows: int, F: int, depth: int,
                   fast: bool = False) -> tuple[float, str]:
    """The survivor demod (kernel B2) of `rows` prefiltered rows a window,
    pattern-major in equal quotas: per row the mix and the pattern sum (8
    FLOPs a sample and active frame), the carrier (one complex product a
    sample; two in the bf16 mode) and the tail; the windows, W, chi, the
    rows' (pos, f, p), the demod tables in and (softbits, nbadsync) out
    once."""
    quota = [rows // depth + (1 if p < rows % depth else 0) for p in range(depth)]
    active = sum(q * int(C.PATTERN_NUM_AVG[p]) for p, q in enumerate(quota))
    n_rows = n_win * rows
    mix = float(C.FRAME_LEN * 8 * n_win * active)
    carrier = C.FRAME_LEN * n_rows * (12 if fast else 6)
    tables = 42 * 8 + 12 * 4 + 8 * 6 * 4 + 8 * 4
    nbytes = (8 * n_win * C.WINDOW_LEN + 8 * F * C.WINDOW_LEN + 8 * F
              + 3 * 4 * n_rows + tables + 4 * n_rows * C.NUM_DATA_BITS + 4 * n_rows)
    return bound(**split_ops(fast, f32=TAIL_F32_FLOPS * n_rows, bf16=mix + carrier,
                             dot=TAIL_DOT_FLOPS * n_rows), nbytes=nbytes)


def bp_bound(updates: float, rows: int) -> tuple[float, str]:
    """LDPC belief propagation (kernel B3) of `rows` rows that need
    `updates` message updates in all (a row found at iteration i runs i, a
    valid row never found the maximum, an invalid row none), each 384 edges
    x 3 special functions and about 12 FLOPs; the LLRs and flags in and the
    found flag, codeword, iterations and hard errors out once."""
    nbytes = rows * (4 * C.NUM_DATA_BITS + 1) + rows * (1 + C.NUM_DATA_BITS + 4 + 4)
    return bound(flops=updates * BP_EDGES * 12, sfu=updates * BP_EDGES * 3, nbytes=nbytes)


def demod_bound(n_win: int, F: int, depth: int, k: int,
                fast: bool = False) -> tuple[float, str]:
    """The full demod (kernel B4) of every candidate of the grid, n_win x F
    x depth x k rows: per (window, f) the mix (6 FLOPs a sample) and one
    complex add a sample per pattern (the running pattern sums), per row
    the tail (in the bf16 mode only the tail's products take bf16
    operands); the windows, W, the rows' positions and the demod tables in
    and (softbits, nbadsync) out once."""
    rows = n_win * F * depth * k
    mix = n_win * F * C.WINDOW_LEN * (6 + 2 * depth)
    tables = 42 * 8 + 12 * 4 + 8 * 6 * 4 + 8 * 4
    nbytes = (8 * n_win * C.WINDOW_LEN + 8 * F * C.WINDOW_LEN + 4 * rows + tables
              + 4 * rows * C.NUM_DATA_BITS + 4 * rows)
    return bound(**split_ops(fast, f32=mix + TAIL_F32_FLOPS * rows, dot=TAIL_DOT_FLOPS * rows),
                 nbytes=nbytes)
