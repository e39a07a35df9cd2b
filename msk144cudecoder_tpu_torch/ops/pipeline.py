"""End-to-end batched decode of raw windows: preprocessing -> scan ->
prefilter -> survivor demod -> survivor selection -> LDPC + CRC -> result
compaction.

Port of msk144cudecoder_tpu/ops/pipeline.py decode_windows, both branches:
the flagship one (the xb prefilter on: scan, survivor demod of the
prefiltered rows, BP) and, with the prefilter off (survivor_prefilter=0),
the full demod of every scan candidate (prepare_window's non-prefilter
branch: scan, full demod, selection over the whole grid, BP). The window
axis B and the flat B*K BP batch are explicit batch dimensions.
`DecodePipeline` holds every constant table as a buffer, so `.to(device)`
moves all of it; on a CUDA device the kernels (csrc/) run, on the CPU their
plain torch versions, with the same glue. cfg.fast_math reaches the scan,
the demod and BP: their bf16 instantiations on a card, their fast plain
versions on the CPU (ops/precision.py); the glue is the same in both modes.

Every ordering the decode depends on keeps the JAX package's tie order:
stable descending sorts for the prefilter and the survivor keys (never
torch.topk, lower index first on ties as lax.top_k orders them), the
two-key (nbadsync asc, xb desc, index asc) survivor sort, and the
found-first stable compaction of the results. Message unpacking and
dedup happen on the host (runtime/).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from .. import constants as C
from ..config import DecoderConfig
from . import analytic, demod, kernels, ldpc, scan, survivor, tables
from .ldpc import BPResult

_N = C.WINDOW_LEN


class WindowDecodeResult(NamedTuple):
    """Fixed-shape per-window outputs, batched over windows (B, ...);
    R = min(cfg.max_results, K) rows per window."""

    cand_index: torch.Tensor  # (B, R) int32 flat index into (F, P, k)
    valid: torch.Tensor  # (B, R) bool: nbadsync <= threshold
    found: torch.Tensor  # (B, R) bool: LDPC + CRC success
    message_bits: torch.Tensor  # (B, R, 10) uint8: the 77 payload bits
    # packed in np.packbits order (unpack with unpack_message_bits)
    nbadsync: torch.Tensor  # (B, R) int32
    xb: torch.Tensor  # (B, R) float32
    pos: torch.Tensor  # (B, R) int32
    ldpc_iterations: torch.Tensor  # (B, R) int32
    hard_errors: torch.Tensor  # (B, R) int32
    num_survivors: torch.Tensor  # (B,) int32: rows under the threshold, of the
    # prefiltered rows (a lower bound) or of the whole grid (prefilter off: exact)
    shard_survivors: torch.Tensor  # (B,) int32: the same on one device
    block_power: torch.Tensor  # (B, 8) float32 sub-block powers for SNR


def pack_message_bits(bits77: torch.Tensor) -> torch.Tensor:
    """(..., 77) {0,1} values -> (..., 10) uint8, np.packbits bit order. The
    bit weights are made on the device (no host copy: a CUDA graph captures
    this)."""
    b = torch.nn.functional.pad(bits77.to(torch.int32), (0, 3))
    b = b.reshape(b.shape[:-1] + (10, 8))
    w = 2 ** torch.arange(7, -1, -1, dtype=torch.int32, device=b.device)
    return (b * w).sum(dim=-1).to(torch.uint8)


def unpack_message_bits(packed) -> np.ndarray:
    """Host side: (..., 10) uint8 -> (..., 77) int8 payload bits."""
    arr = np.asarray(packed, dtype=np.uint8)
    return np.unpackbits(arr, axis=-1)[..., :77].astype(np.int8)


def block_powers(c: torch.Tensor) -> torch.Tensor:
    """(..., 8) sub-block signal powers of analytic windows (..., N)."""
    return (torch.abs(c.reshape(c.shape[:-1] + (8, _N // 8))) ** 2).sum(dim=-1).to(
        torch.float32)


def split_quota(total: int, parts: int) -> list[int]:
    return [total // parts + (1 if p < total % parts else 0)
            for p in range(parts)]


_PREFILTER_BLK = 128  # the JAX survivor kernel's block: prefilter sizes round up to it


def resolve_prefilter(cfg: DecoderConfig, nc: int) -> int:
    """Effective xb-prefilter size (0 = full demod). The port always has its
    survivor kernel, so auto (None) is 2 * max_survivors, as on the JAX
    package's kernel path; explicit values round up to the block and are
    disabled when they would not shrink the work."""
    p = cfg.survivor_prefilter
    if p is None:
        p = 2 * cfg.max_survivors
    if p <= 0:
        return 0
    p = -(-p // _PREFILTER_BLK) * _PREFILTER_BLK
    return 0 if p >= nc else p


def prefilter_per_cell(cfg: DecoderConfig, cells: int, pre: int) -> int:
    """The per-cell cap, raised until the cells hold at least `pre`
    candidates."""
    per_cell = cfg.prefilter_per_cell
    while per_cell < cfg.candidates_per_pattern and cells * per_cell < pre:
        per_cell += 1
    return per_cell


def prefilter_select(xb: torch.Tensor, pos: torch.Tensor, pre: int, per_cell: int):
    """Top candidates by scan xb: at most `per_cell` per (freq, pattern)
    cell, then a per-pattern quota summing to `pre`.

    xb, pos (B, F, P, S) from the scan (each cell's slots in descending xb
    order, so the per-cell cap is a slice). Returns (xb_sel, pos_sel, f_idx,
    p_idx, flat_idx), each (B, pre), pattern-major: pattern p's quota rows
    follow pattern p-1's."""
    nb, F, P, S = xb.shape
    dev = xb.device
    xb2 = xb[..., :per_cell]
    pos2 = pos[..., :per_cell]
    flat2 = (torch.arange(F * P, dtype=torch.int32, device=dev)[:, None] * S
             + torch.arange(per_cell, dtype=torch.int32, device=dev)).reshape(F, P, per_cell)
    # pattern-major views: row p holds all F * per_cell candidates of pattern p
    xb_p = xb2.permute(0, 2, 1, 3).reshape(nb, P, F * per_cell)
    pos_p = pos2.permute(0, 2, 1, 3).reshape(nb, P, F * per_cell)
    flat_p = flat2.permute(1, 0, 2).reshape(1, P, F * per_cell).expand(nb, -1, -1)
    xb_s, order = torch.sort(xb_p, dim=-1, descending=True, stable=True)
    pos_s = torch.gather(pos_p, -1, order)
    flat_s = torch.gather(flat_p, -1, order)
    quota = split_quota(pre, P)
    xb_sel = torch.cat([xb_s[:, p, : quota[p]] for p in range(P)], dim=-1)
    pos_sel = torch.cat([pos_s[:, p, : quota[p]] for p in range(P)], dim=-1)
    flat_idx = torch.cat([flat_s[:, p, : quota[p]] for p in range(P)], dim=-1)
    f_idx = torch.div(flat_idx, P * S, rounding_mode="floor")
    p_idx = torch.div(flat_idx % (P * S), S, rounding_mode="floor")
    return (xb_sel, pos_sel.to(torch.int32), f_idx.to(torch.int32),
            p_idx.to(torch.int32), flat_idx.to(torch.int32))


def select_survivors(nbad_f: torch.Tensor, xb_f: torch.Tensor, k: int) -> torch.Tensor:
    """First k indices of the last axis in exact lexicographic (nbadsync
    asc, xb desc, index asc) order: a stable sort on xb descending, then a
    stable sort on nbadsync."""
    o1 = torch.sort(torch.clamp_min(xb_f, 0.0), dim=-1, descending=True, stable=True)[1]
    nb1 = torch.gather(nbad_f, -1, o1)
    o2 = torch.sort(nb1, dim=-1, stable=True)[1]
    return torch.gather(o1, -1, o2)[..., :k]


# select_survivors_topk exactness domain: xb clamped into [2^-4, 2^20)
_XB_LO = 2.0 ** -4
_XB_HI = float(np.float32(2.0 ** 20) * (1.0 - 2.0 ** -24))
TOPK_MAX_THRESHOLD = 4  # the JAX package's single-key path holds for threshold <= 4


def select_survivors_topk(nbad_f: torch.Tensor, xb_f: torch.Tensor, k: int,
                          threshold: int, mask: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """The JAX package's single-key survivor order: key = clamp(xb, 2^-4,
    2^20) * 2^(-24 * min(nbad, threshold + 1)), an exact power-of-two shift,
    ranked descending with lower index first on ties. Rows outside `mask`
    (broadcast over the last axis) get key 0 and rank last: real keys are
    > 0."""
    cls = torch.clamp_max(nbad_f, threshold + 1).to(torch.int32)
    key = torch.ldexp(torch.clamp(xb_f, _XB_LO, _XB_HI), -24 * cls)
    if mask is not None:
        key = torch.where(mask, key, torch.zeros((), dtype=key.dtype, device=key.device))
    return torch.sort(key, dim=-1, descending=True, stable=True)[1][..., :k]


def select_survivors_quota(nbad_f: torch.Tensor, xb_f: torch.Tensor, k: int,
                           threshold: int, quotas: list[tuple[int, object]]
                           ) -> torch.Tensor:
    """Survivor selection with a per-pattern slot quota (summing to k). A
    (quota, slice) segment of a pattern-major axis (the prefiltered rows)
    keeps its best `quota` rows by select_survivors; a (quota, mask) segment
    over the whole axis (the full grid) keeps its best `quota` rows of the
    mask by select_survivors_topk, so that rows under the threshold share
    one bucket ordered by xb alone."""
    parts = []
    for q, seg in quotas:
        if isinstance(seg, slice):
            parts.append(select_survivors(nbad_f[..., seg], xb_f[..., seg], q) + seg.start)
        else:
            parts.append(select_survivors_topk(nbad_f, xb_f, q, threshold, mask=seg))
    return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]


class PreparedWindows(NamedTuple):
    """Per-window state between survivor selection and BP, batched (B, K)."""

    llr: torch.Tensor  # (B, K, 128) float32
    valid: torch.Tensor  # (B, K) bool
    nbad_k: torch.Tensor  # (B, K) int32
    xb_k: torch.Tensor  # (B, K) float32
    pos_k: torch.Tensor  # (B, K) int32
    cand_k: torch.Tensor  # (B, K) int32
    num_survivors: torch.Tensor  # (B,) int32


def survivor_index(nbad_f: torch.Tensor, xb_f: torch.Tensor, cfg: DecoderConfig,
                   p_idx: torch.Tensor | None = None) -> torch.Tensor:
    """(B, k) indices of the survivors chosen for BP among the rows (B, nc),
    k = min(max_survivors, nc), as prepare_window chooses them. With
    threshold <= 4 and k >= P > 1, a per-pattern quota: p_idx None means
    pattern-major rows (the prefilter's quota runs, slice segments), else
    p_idx (nc,) gives each row's pattern (the full grid, mask segments)."""
    P = cfg.scan_depth
    nc_sel = nbad_f.shape[-1]
    k = min(cfg.max_survivors, nc_sel)
    thr = cfg.nbadsync_threshold
    if thr > TOPK_MAX_THRESHOLD:
        return select_survivors(nbad_f, xb_f, k)
    if not k >= P > 1:
        return select_survivors_topk(nbad_f, xb_f, k, thr)
    if p_idx is None:
        offs = np.cumsum([0] + split_quota(nc_sel, P))
        segs = [slice(int(offs[p]), int(offs[p + 1])) for p in range(P)]
    else:
        segs = [p_idx == p for p in range(P)]
    return select_survivors_quota(nbad_f, xb_f, k, thr, list(zip(split_quota(k, P), segs)))


def select_stage(sb_f, nbad_f, xb_f, pos_f, cand_all, cfg: DecoderConfig,
                 p_idx: torch.Tensor | None = None) -> PreparedWindows:
    """Survivor selection over the demodulated rows (B, nc_sel), then the
    row take for BP: the prefiltered rows, pattern-major, or (p_idx given)
    the whole candidate grid. num_survivors counts every row."""
    thr = cfg.nbadsync_threshold
    top_idx = survivor_index(nbad_f, xb_f, cfg, p_idx)
    llr = torch.gather(sb_f, 1, top_idx[..., None].expand(-1, -1, sb_f.shape[-1]))
    nbad_k = torch.gather(nbad_f, 1, top_idx)
    return PreparedWindows(
        llr=llr, valid=nbad_k <= thr, nbad_k=nbad_k,
        xb_k=torch.gather(xb_f, 1, top_idx),
        pos_k=torch.gather(pos_f, 1, top_idx),
        cand_k=torch.gather(cand_all, 1, top_idx),
        num_survivors=(nbad_f <= thr).sum(dim=-1).to(torch.int32))


def finish_stage(prep: PreparedWindows, bp: BPResult, block_power: torch.Tensor,
                 cfg: DecoderConfig) -> WindowDecodeResult:
    """Result compaction per window: the first max_results rows with decodes
    first, each group in survivor-rank order (a stable sort on not-found)."""
    k = prep.llr.shape[1]
    r = min(cfg.max_results, k)
    sel = torch.sort((~bp.found).to(torch.int32), dim=-1, stable=True)[1][:, :r]

    def take(a):
        return torch.gather(a, 1, sel)

    cw = torch.gather(bp.codeword[..., : C.NUM_MESSAGE_BITS], 1,
                      sel[..., None].expand(-1, -1, C.NUM_MESSAGE_BITS))
    return WindowDecodeResult(
        cand_index=take(prep.cand_k),
        valid=take(prep.valid),
        found=take(bp.found),
        message_bits=pack_message_bits(cw),
        nbadsync=take(prep.nbad_k),
        xb=take(prep.xb_k),
        pos=take(prep.pos_k),
        ldpc_iterations=take(bp.iterations),
        hard_errors=take(bp.hard_errors),
        num_survivors=prep.num_survivors,
        shard_survivors=prep.num_survivors,
        block_power=block_power,
    )


class DecodePipeline(nn.Module):
    """The decode of one configuration over one frequency grid. Buffers: the
    frequency tables (B, E in the scan's (F, N/dec) layout, chi, W), the
    analytic shift carriers and FFT mask, the demod constants (sync vector,
    matched-filter taps, pattern masks, sync word), the LDPC edge tables
    NM/MN plus the CRC matrix, and the channel mask. forward(raw) runs all
    stages; the stage methods are public so that a caller can time them one
    by one.

    `freqs` is the grid (default cfg.freqs): a frequency shard passes its
    slice of the padded grid, and all sizes, the prefilter included, follow
    the local grid. `chan_valid` (F,) bool masks channels out of the
    results (the sharding pad past the right boundary), as prepare_window
    masks them: their xb is 0 before the prefilter, their nbadsync 17 after
    the demod. `pre` is the resolved prefilter size: 0 runs the full demod
    of every candidate (kernel B4)."""

    def __init__(self, cfg: DecoderConfig, freqs=None, chan_valid=None):
        super().__init__()
        freqs = cfg.freqs if freqs is None else np.asarray(freqs, dtype=np.float64)
        F = len(freqs)
        self.grid = (F, cfg.scan_depth, cfg.candidates_per_pattern)  # (F, P, k)
        self.nc = F * cfg.scan_depth * cfg.candidates_per_pattern
        self.pre = resolve_prefilter(cfg, self.nc)
        self.cfg = cfg
        self.per_cell = prefilter_per_cell(cfg, F * cfg.scan_depth, self.pre)

        if chan_valid is not None:
            chan_valid = torch.as_tensor(np.asarray(chan_valid, dtype=bool))
            if chan_valid.shape != (F,):
                raise ValueError(f"chan_valid has shape {tuple(chan_valid.shape)}, "
                                 f"expected ({F},)")
        self.register_buffer("chan_valid", chan_valid)
        t = tables.cached_freq_tables(tuple(float(f) for f in freqs))
        tt = tables.to_torch(t, "cpu")
        self.register_buffer("B", tt.B)
        self.register_buffer("E_dec", tables.e_decimated(tt.E, cfg.scan_decimation))
        self.register_buffer("chi", tt.chi)
        self.register_buffer("W", tt.W)
        left, right = analytic.shift_tables()
        self.register_buffer("shift_left", torch.from_numpy(left))
        self.register_buffer("shift_right", torch.from_numpy(right))
        self.register_buffer("bpf", torch.from_numpy(analytic.bpf_half()))
        for name, value in tables.demod_to_torch("cpu")._asdict().items():
            self.register_buffer(name, value)
        for name, value in tables.ldpc_to_torch("cpu")._asdict().items():
            self.register_buffer("ldpc_" + name, value)

    @property
    def demod_tables(self) -> tables.DemodTables:
        return tables.DemodTables(self.sync_conj, self.pp12, self.masks, self.sync_pm)

    @property
    def ldpc_tables(self) -> tables.TorchLdpcTables:
        return tables.TorchLdpcTables(*(getattr(self, "ldpc_" + name)
                                        for name in tables.TorchLdpcTables._fields))

    def preprocess(self, raw: torch.Tensor) -> torch.Tensor:
        """Raw windows (B, raw_len) -> analytic complex64 windows (B, N).
        read_mode 1: int16/float audio, RMS-normalised then converted;
        read_mode 2: interleaved int8 IQ scaled by 1/128, then low-passed."""
        cfg = self.cfg
        if cfg.read_mode == 1:
            x = analytic.rms_normalize(raw)
            if cfg.analytic_method == 1:
                return analytic.analytic_method1(x, self.bpf)
            return analytic.analytic_method2(x, (self.shift_left, self.shift_right))
        z = raw.to(torch.float32) / 128.0
        return analytic.iq_filter(torch.complex(z[..., 0::2], z[..., 1::2]))

    def scan(self, c: torch.Tensor):
        cfg = self.cfg
        return scan.scan(c, self.B, self.E_dec, self.chi, cfg.scan_depth,
                         cfg.candidates_per_pattern, cfg.scan_decimation, cfg.fast_math)

    def prefilter(self, pos: torch.Tensor, xb: torch.Tensor):
        """The rows to demodulate, (xb, pos, f_idx, p_idx, flat_idx) each
        (B, rows): the prefilter's top `pre` rows, pattern-major, or with
        the prefilter off every candidate of the grid in (F, P, k) order.
        Masked channels' xb is 0 on both paths."""
        if self.chan_valid is not None:
            xb = torch.where(self.chan_valid[:, None, None], xb,
                             torch.zeros((), dtype=xb.dtype, device=xb.device))
        if self.pre:
            return prefilter_select(xb, pos, self.pre, self.per_cell)
        nb = pos.shape[0]
        flat = torch.arange(self.nc, dtype=torch.int32, device=pos.device)
        per_f = pos.shape[2] * pos.shape[3]
        f_idx = torch.div(flat, per_f, rounding_mode="floor")
        p_idx = torch.div(flat % per_f, pos.shape[3], rounding_mode="floor")
        return (xb.reshape(nb, self.nc), pos.reshape(nb, self.nc),
                *(a.expand(nb, -1) for a in (f_idx, p_idx, flat)))

    def demod(self, c: torch.Tensor, front):
        """(softbits (B, rows, 128), nbadsync (B, rows)) of the front's rows:
        kernel B2 on the prefiltered rows, kernel B4 on the full grid.
        Masked channels' rows get nbadsync 17, above any threshold."""
        _, pos_f, f_idx, p_idx, _ = front
        fast = self.cfg.fast_math
        if self.pre:
            sb, nbad = survivor.demod_survivors(c, self.W, self.chi, pos_f, f_idx, p_idx,
                                                self.demod_tables, fast)
        else:
            nb = pos_f.shape[0]
            sb, nbad = demod.demod_candidates(c, self.W, pos_f.reshape((nb,) + self.grid),
                                              self.demod_tables, fast)
            sb = sb.reshape(nb, self.nc, C.NUM_DATA_BITS)
            nbad = nbad.reshape(nb, self.nc)
        if self.chan_valid is not None:
            nbad = torch.where(self.chan_valid[f_idx.long()], nbad,
                               torch.full((), 17, dtype=nbad.dtype, device=nbad.device))
        return sb, nbad

    def select(self, sb_f, nbad_f, front) -> PreparedWindows:
        xb_f, pos_f, _, p_idx, flat_idx = front
        return select_stage(sb_f, nbad_f, xb_f, pos_f, flat_idx, self.cfg,
                            p_idx=None if self.pre else p_idx[0])

    def bp(self, prep: PreparedWindows) -> BPResult:
        b, k = prep.valid.shape
        flat = ldpc.bp_decode(prep.llr.reshape(b * k, C.NUM_DATA_BITS),
                              prep.valid.reshape(b * k), self.ldpc_tables,
                              fast=self.cfg.fast_math)
        return BPResult(*(a.reshape((b, k) + a.shape[1:]) for a in flat))

    def finish(self, prep: PreparedWindows, bp: BPResult, c: torch.Tensor
               ) -> WindowDecodeResult:
        return finish_stage(prep, bp, block_powers(c), self.cfg)

    @torch.no_grad()
    def forward(self, raw: torch.Tensor) -> WindowDecodeResult:
        c = self.preprocess(raw)
        pos, xb = self.scan(c)
        front = self.prefilter(pos, xb)
        sb_f, nbad_f = self.demod(c, front)
        prep = self.select(sb_f, nbad_f, front)
        return self.finish(prep, self.bp(prep), c)


def decode_raw(raw, cfg: DecoderConfig, device=None) -> WindowDecodeResult:
    """Batch of raw windows (B, raw_len) -> batched results on `device`
    (default: the card; without one this raises unless device is "cpu").
    Builds the pipeline on each call, so it runs eagerly: a CUDA graph
    (ops/graphs.py) pays off only over many passes of one pipeline, as a
    stream makes them (runtime.StreamDecoder keeps one, and its graphs)."""
    if not isinstance(raw, torch.Tensor):
        raw = torch.from_numpy(np.asarray(raw))
    device = kernels.resolve_device(device)
    return DecodePipeline(cfg).to(device)(raw.to(device))


def raw_window_len(cfg: DecoderConfig) -> int:
    return _N * 2 if cfg.read_mode == 2 else _N


def unpack_candidate_index(cfg: DecoderConfig, flat_idx: int) -> tuple[int, int, int]:
    """Flat candidate index -> (freq_idx, pattern_idx, candidate_num)."""
    per_f = cfg.scan_depth * cfg.candidates_per_pattern
    fi, rem = divmod(int(flat_idx), per_f)
    pi, cn = divmod(rem, cfg.candidates_per_pattern)
    return fi, pi, cn
