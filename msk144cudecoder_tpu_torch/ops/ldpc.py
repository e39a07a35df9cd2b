"""LDPC(128,90) belief propagation + CRC-13 gate: the plain torch version
and the kernel B3 wrapper.

Port of msk144cudecoder_tpu/ops/ldpc.py (platanh, _loo_log_domain,
bp_decode) and of the kernel ops/pallas_ldpc.py::_bp_kernel. Edges are
indexed through the NM/MN tables (edge e = 11 * check + slot) instead of the
JAX package's one-hot matmuls. Per iteration, in the order of the reference:

  zn = llr + sum of the bit's 3 check messages (slot order)
  cw = zn > 0; the 38 parity checks, the CRC-13 of cw[:77] against
  cw[77:90], hard errors (cw != llr > 0) < 18 and `valid` gate success;
  a row's outputs freeze at its first success
  toc[e] = zn[bit(e)] - tov[e];  t = tanh(-toc / 2)
  leave-one-out product of t over each check row, in the log domain:
  |loo| = exp2(sum_row log2|t| - log2|t_own|), sign from the parity of the
  other negatives;  tov[e] = 2 * platanh(-loo)

Iteration 0 checks zn = llr. The sums run in a fixed sequential order
(slots 0..2 for zn, 0..10 for a check row), the order kernel B3 uses, so the
two differ only by the device's tanh/log2/exp2 rounding. With fast=True
(DecoderConfig.fast_math) the messages round to bf16 where the JAX kernel's
fast mode rounds them (ops/precision.py, B3).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as C
from ..protocol import ldpc_tables as T
from . import kernels
from .precision import round_bf16
from .tables import TorchLdpcTables

_LOG_FLOOR = 2.0 ** -80  # |t| floor before log2: a zero message floors at
# -80, so sum - own still recovers the product of the other edges


class BPResult(NamedTuple):
    found: torch.Tensor  # (R,) bool
    codeword: torch.Tensor  # (R, 128) int8
    iterations: torch.Tensor  # (R,) int32
    hard_errors: torch.Tensor  # (R,) int32


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d as a true division on every device (torch's CUDA division by a
    Python scalar multiplies by its reciprocal instead, which rounds
    differently from the reference's and kernel B3's division)."""
    return x / torch.full_like(x, d)


def platanh(x: torch.Tensor) -> torch.Tensor:
    """The reference's 5-segment piecewise-linear atanh."""
    z = torch.abs(x)
    s = torch.where(x < 0.0, -1.0, 1.0)
    return torch.where(
        z <= 0.664,
        _div(x, 0.83),
        s * torch.where(
            z <= 0.9217,
            _div(z - 0.4064, 0.322),
            torch.where(
                z <= 0.9951,
                _div(z - 0.8378, 0.0524),
                torch.where(z <= 0.9998, _div(z - 0.9914, 0.0012), 7.0),
            ),
        ),
    )


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis (a check row's 11 slots), in slot order."""
    S = x[..., 0]
    for j in range(1, x.shape[-1]):
        S = S + x[..., j]
    return S


def split2(x: torch.Tensor) -> torch.Tensor:
    """x as the sum of two bf16 parts h + l (about 16 mantissa bits)."""
    h = round_bf16(x)
    return h + round_bf16(x - h)


def loo_log_domain(t: torch.Tensor, edge_valid: torch.Tensor, fast: bool = False) -> torch.Tensor:
    """Leave-one-out products of t (R, 38, 11) along each check row (padded
    edges hold t = 1, so log2|t| = 0 and they drop out of the row sum).
    fast: the row sum is sum(h) + sum(l) of the log2 terms' two bf16 parts,
    and reaches the edges as its own two bf16 parts."""
    lt = torch.log2(torch.clamp_min(torch.abs(t), _LOG_FLOOR))
    if fast:
        h = round_bf16(lt)
        S = split2(row_sum(h) + row_sum(round_bf16(lt - h)))
    else:
        S = row_sum(lt)
    mag = torch.exp2(S[..., None] - lt)
    neg = ((t < 0.0) & edge_valid).to(torch.int32)
    others = neg.sum(dim=-1, keepdim=True) - neg
    return (1.0 - 2.0 * (others % 2).to(t.dtype)) * mag


def bp_decode_plain(llr: torch.Tensor, valid: torch.Tensor, lt: TorchLdpcTables,
                    max_iters: int = C.NUM_BP_ITERATIONS, fast: bool = False) -> BPResult:
    """Plain torch BP over rows llr (R, 128) float32 with valid (R,) bool;
    fast: the messages in bf16 where the JAX kernel's fast mode has them."""
    R = llr.shape[0]
    dev = llr.device
    edge_valid = lt.nm >= 0  # (38, 11)
    bit = lt.nm.clamp_min(0).long()  # (38, 11)
    mn = lt.mn_edge.long()  # (128, 3)
    crc = lt.crc.to(torch.int32)  # (13, 77)
    hard_in = llr > 0.0

    tov = torch.zeros((R, T.N_CHECKS, T.MAX_ROW_DEGREE), dtype=torch.float32, device=dev)
    found = torch.zeros((R,), dtype=torch.bool, device=dev)
    cw_s = torch.zeros((R, T.N_BITS), dtype=torch.int8, device=dev)
    iter_s = torch.zeros((R,), dtype=torch.int32, device=dev)
    nerr_s = torch.zeros((R,), dtype=torch.int32, device=dev)
    for it in range(max_iters):
        tflat = tov.reshape(R, -1)
        if fast:
            tb = round_bf16(tflat)
            zn = llr + (tb[:, mn[:, 0]] + tb[:, mn[:, 1]] + tb[:, mn[:, 2]])
        else:
            zn = llr + tflat[:, mn[:, 0]] + tflat[:, mn[:, 1]] + tflat[:, mn[:, 2]]
        cw = zn > 0.0
        cwi = cw.to(torch.int32)
        par = (cwi[:, bit] * edge_valid).sum(dim=-1) % 2  # (R, 38)
        crc_bits = (cwi[:, None, : C.NUM_MESSAGE_BITS] * crc).sum(dim=-1) % 2
        crc_ok = (crc_bits == cwi[:, C.NUM_MESSAGE_BITS : C.NUM_INFO_BITS]).all(dim=-1)
        nerr = (cw != hard_in).sum(dim=-1).to(torch.int32)
        ok = (par.sum(dim=-1) == 0) & crc_ok & (nerr < C.MAX_HARD_ERRORS) & valid
        newly = ok & ~found
        cw_s = torch.where(newly[:, None], cw.to(torch.int8), cw_s)
        iter_s = torch.where(newly, it, iter_s)
        nerr_s = torch.where(newly, nerr, nerr_s)
        found = found | newly

        toc = (round_bf16(zn) if fast else zn)[:, bit] - tov  # (R, 38, 11)
        t = torch.where(edge_valid, torch.tanh(-0.5 * toc), 1.0)
        loo = loo_log_domain(t, edge_valid, fast)
        tov = torch.where(edge_valid, 2.0 * platanh(-loo), 0.0)
    return BPResult(found, cw_s, iter_s, nerr_s)


def bp_decode_cuda(llr: torch.Tensor, valid: torch.Tensor, lt: TorchLdpcTables,
                   max_iters: int = C.NUM_BP_ITERATIONS, fast: bool = False) -> BPResult:
    """Kernel B3 (csrc/bp.cu): one block of 128 threads per codeword row;
    fast launches its bf16 instantiation. llr (R, 128) float32, valid (R,)
    bool and the tables' packed forms, contiguous on one CUDA device."""
    R = llr.shape[0] if llr.dim() == 2 else -1
    n_edges = 3 * T.N_BITS
    kernels.check_tensors("bp_decode",
                          llr=(llr, torch.float32, (R, T.N_BITS)),
                          valid=(valid, torch.bool, (R,)),
                          edge=(lt.edge, torch.int32, (n_edges,)),
                          bit_edges=(lt.bit_edges, torch.int32, (T.N_BITS,)),
                          row_start=(lt.row_start, torch.int32, (T.N_CHECKS + 1,)),
                          check_mask=(lt.check_mask, torch.int32, (T.N_CHECKS, T.N_BITS // 32)),
                          crc_mask=(lt.crc_mask, torch.int32, (C.NUM_CRC_BITS, 3)))
    if not 0 <= max_iters <= 1000:
        raise ValueError(f"max_iters must be in [0, 1000], got {max_iters}")
    dev = llr.device
    cw = torch.empty((R, T.N_BITS), dtype=torch.int8, device=dev)
    found = torch.empty((R,), dtype=torch.bool, device=dev)
    iters = torch.empty((R,), dtype=torch.int32, device=dev)
    nerr = torch.empty((R,), dtype=torch.int32, device=dev)
    if R:
        lib = kernels.library()
        with torch.cuda.device(dev):
            rc = lib.msk_bp(llr.data_ptr(), valid.data_ptr(), lt.edge.data_ptr(),
                            lt.bit_edges.data_ptr(), lt.row_start.data_ptr(),
                            lt.check_mask.data_ptr(), lt.crc_mask.data_ptr(), cw.data_ptr(),
                            found.data_ptr(), iters.data_ptr(), nerr.data_ptr(),
                            R, max_iters, int(fast), kernels.stream_ptr(dev))
        kernels.raise_on_error("msk_bp", rc)
        kernels.count_launch(bp_decode_cuda, fast)
    return BPResult(found, cw, iters, nerr)


bp_decode_cuda.launches = 0
bp_decode_cuda.launches_fast = 0


def bp_decode(llr: torch.Tensor, valid: torch.Tensor, lt: TorchLdpcTables,
              max_iters: int = C.NUM_BP_ITERATIONS, fast: bool = False) -> BPResult:
    """BP over rows llr (R, 128): kernel B3 on a CUDA tensor, the plain
    version on the CPU."""
    if kernels.on_cuda(llr):
        return bp_decode_cuda(llr, valid, lt, max_iters, fast)
    return bp_decode_plain(llr, valid, lt, max_iters, fast)
