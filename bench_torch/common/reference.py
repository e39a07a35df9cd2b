"""The plain reference decoder that decides `correct`.

A straightforward float32 decode of MSK144 windows in plain torch, with the
semantics the configuration states: the analytic signal (shift, 15-tap
half-band FIR both ways, shift back), the sync scan of every frequency of
the grid at every dec-th lag with the frame-averaging patterns up to the
scan depth, the best lag of each 256-lag slice and the top-k slices per
(frequency, pattern), then one of two paths, as the configuration's
`survivor_prefilter` resolves:

- the prefilter path: the xb prefilter (at most `per_cell` rows per cell,
  a per-pattern quota), the survivor demod of those rows (pattern-averaged
  mixed-down frame, carrier phase from both sync regions, the half-sine
  matched filter, nbadsync) and the survivor choice among them
  (max_survivors rows by nbadsync, then xb, under per-pattern quotas over
  the pattern-major rows);
- the full-demod path (`survivor_prefilter` <= 0, or a size that covers
  the grid): the demod of every (frequency, pattern, lag) candidate, in
  blocks of (window, frequency) cells, and the same survivor choice over
  the whole grid, each pattern's quota taken under a mask of its rows;

then on both paths LDPC(128,90) belief propagation with the CRC-13 gate,
and on the host unpack77, the per-window dedup and the SNR tracker.

It transcribes the port's CPU path (its kernels' plain versions and its
glue), which the repository's tests hold equal to the JAX package's
decode; it imports nothing of the program and builds every table itself
from the protocol constants in `proto/`. It covers the configurations the
benchmark runs: 16-bit audio, analytic method 2, either path, float32
(TF32 off). Batches of windows run on any device; the host
post-processing runs window by window.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch

from .proto import constants as C
from .proto import crc as crc_mod
from .proto import ldpc_tables as T
from .proto import msg77

_N = C.WINDOW_LEN
_TAPS = C.SYNC_CORR_LEN
_M = C.PATTERN_LEN
_PREFILTER_BLK = 128
# the full demod's block: the candidates' frames (cells, P, k, 864) complex64
# of one block of (window, frequency) cells, its largest intermediate (the
# gather index has as many int64); with the pattern sums and the tail's
# temporaries a block holds about 1.5 GiB at its peak
_FULL_BLOCK_BYTES = 256 << 20
_LOG_FLOOR = 2.0 ** -80
TOPK_MAX_THRESHOLD = 4
_XB_LO = 2.0 ** -4
_XB_HI = float(np.float32(2.0 ** 20) * (1.0 - 2.0 ** -24))


class Settings(NamedTuple):
    """The decode a configuration states (the DecoderConfig keywords the
    benchmark's configurations use)."""

    freqs: np.ndarray
    scan_depth: int
    nbadsync_threshold: int
    max_survivors: int
    max_results: int
    candidates_per_pattern: int
    survivor_prefilter: int | None
    prefilter_per_cell: int
    scan_decimation: int

    @classmethod
    def from_config(cls, kw: dict) -> "Settings":
        if kw.get("read_mode", 1) != 1 or kw.get("analytic_method", 2) != 2:
            raise ValueError("the reference decodes 16-bit audio with analytic method 2")
        if kw.get("fast_math", False):
            raise ValueError("the reference computes in float32")
        step = kw.get("search_step", 2.0)
        width = kw.get("search_width", 200.0)
        center = kw.get("center_frequency", 1500.0)
        half = int((width / 2) / step)
        freqs = (center - half * step + np.arange(2 * half + 1) * step).astype(np.float64)
        return cls(freqs=freqs,
                   scan_depth=min(max(int(kw.get("scan_depth", 4)), 1), C.SCAN_DEPTH_MAX),
                   nbadsync_threshold=int(kw.get("nbadsync_threshold", 1)),
                   max_survivors=int(kw.get("max_survivors", 256)),
                   max_results=int(kw.get("max_results", 64)),
                   candidates_per_pattern=int(kw.get("candidates_per_pattern", 8)),
                   survivor_prefilter=kw.get("survivor_prefilter"),
                   prefilter_per_cell=int(kw.get("prefilter_per_cell", 2)),
                   scan_decimation=int(kw.get("scan_decimation", 4)))


# --- tables -------------------------------------------------------------------

def freq_tables(freqs: np.ndarray, dec: int, device):
    """B (42, F), E on the coarse lags (F, N/dec), chi (F,), W (F, N), all
    complex64 from float64 phases reduced mod 1."""
    i = np.arange(_TAPS)
    B = C.CB42[:, None] * np.exp(2j * np.pi * freqs[None, :] * i[:, None] / C.SAMPLE_RATE)
    phase = np.mod(np.outer(np.arange(_N), freqs) / C.SAMPLE_RATE, 1.0)
    E = np.exp(2j * np.pi * phase).astype(np.complex64)
    chi = (np.exp(-2j * np.pi * freqs * _N / C.SAMPLE_RATE) - 1.0).astype(np.complex64)
    W = np.exp(-2j * np.pi * phase.T).astype(np.complex64)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (put(B.astype(np.complex64)), put(E[::dec, :].T), put(chi), put(W))


# --- preprocess ---------------------------------------------------------------

def _fir_taps():
    return [(k, float(h)) for k, h in enumerate(C.FIR15) if h != 0.0]


def analytic(raw: torch.Tensor) -> torch.Tensor:
    """(B, N) int16 audio -> (B, N) complex64 analytic windows: 1/rms
    normalisation, shift by -fs/8, the FIR forward then backward, shift back."""
    x = raw.to(torch.float32)
    rms = torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True))
    x = x / torch.clamp_min(rms, 1e-30)
    pad = C.FIR_PAD
    n = np.arange(_N + 2 * pad)
    left = torch.from_numpy(np.exp(-2j * np.pi * (n + 1) / 8.0).astype(np.complex64)).to(x.device)
    right = torch.from_numpy(np.exp(2j * np.pi * n / 8.0).astype(np.complex64)).to(x.device)
    z0 = torch.zeros(x.shape[:-1] + (pad,), dtype=x.dtype, device=x.device)
    z = torch.cat([z0, x, z0], dim=-1).to(torch.complex64) * left
    m = z.shape[-1] - 32
    acc = torch.zeros_like(z[..., :m])
    for k, h in _fir_taps():
        acc = acc + h * z[..., 15 - k: 15 - k + m]
    z = torch.cat([acc, z[..., m:]], dim=-1)
    acc = torch.zeros_like(z[..., :m])
    for k, h in _fir_taps():
        acc = acc + h * z[..., 17 + k: 17 + k + m]
    z = torch.cat([z[..., :32], acc], dim=-1) * right
    return z[..., pad: pad + _N].contiguous()


def block_powers(c: torch.Tensor) -> torch.Tensor:
    """(B, 8) sub-block powers of analytic windows (B, N)."""
    return (torch.abs(c.reshape(c.shape[:-1] + (8, _N // 8))) ** 2).sum(dim=-1).to(torch.float32)


# --- scan ---------------------------------------------------------------------

def scan(c, B, E_dec, chi, depth: int, num_cand: int, dec: int):
    """(pos int32, xb float32) each (B, F, P, k)."""
    n2 = _N // dec
    dev = c.device
    lags = torch.arange(0, _N, dec, device=dev)
    taps = torch.arange(_TAPS, device=dev)
    ext = torch.cat([c, c[..., : _TAPS - 1]], dim=-1)
    R = torch.matmul(ext[..., lags[:, None] + taps[None, :]].conj(), B)
    nt = int((lags >= _N - (_TAPS - 1)).sum())
    lt = lags[n2 - nt:]
    wrapped = (lt[:, None] + taps[None, :]) >= _N
    bidx = torch.where(wrapped, lt[:, None] + taps[None, :] - _N, 0)
    bnd = torch.where(wrapped, c[..., bidx], torch.zeros((), dtype=c.dtype, device=dev))
    D = torch.matmul(bnd.conj(), B)
    R = torch.cat([R[..., : n2 - nt, :], R[..., n2 - nt:, :] + chi * D], dim=-2)
    G = E_dec.transpose(0, 1) * R

    def roll(a: int):
        return torch.roll(G, -(a // dec), dims=-2)

    Tm = [roll(864 * m) + roll(864 * m + C.SECOND_SYNC_SAMPLE) for m in range(_M)]
    S = [Tm[0]]
    for m in range(1, 6):
        S.append(S[-1] + Tm[m])
    S.append(Tm[0] + Tm[3])
    S.append(Tm[0] + Tm[3] + Tm[4])
    xb = torch.abs(torch.stack(S[:depth], dim=-3)).to(torch.float32)  # (B, P, n2, F)

    slice2 = C.SCAN_SLICE // dec
    pad2 = C.NUM_SCAN_SLICES * slice2
    xbp = torch.cat([xb, xb[..., : pad2 - n2, :]], dim=-2)
    sl = xbp.reshape(xb.shape[:-2] + (C.NUM_SCAN_SLICES, slice2, xb.shape[-1]))
    smax = sl.amax(dim=-2)
    lag = torch.arange(slice2, device=dev)[:, None]
    sarg = torch.where(sl == smax.unsqueeze(-2), lag, slice2).amin(dim=-2)
    sm = smax.movedim(-1, -3)
    sa = sarg.movedim(-1, -3)
    vals, order = torch.sort(sm, dim=-1, descending=True, stable=True)
    top = order[..., :num_cand]
    pos = (top * C.SCAN_SLICE + dec * torch.gather(sa, -1, top)) % _N
    return pos.to(torch.int32), vals[..., :num_cand].contiguous()


# --- prefilter and survivor choice ---------------------------------------------

def split_quota(total: int, parts: int) -> list:
    return [total // parts + (1 if p < total % parts else 0) for p in range(parts)]


def prefilter_size(s: Settings, nc: int) -> int:
    p = s.survivor_prefilter
    if p is None:
        p = 2 * s.max_survivors
    if p <= 0:
        return 0
    p = -(-p // _PREFILTER_BLK) * _PREFILTER_BLK
    return 0 if p >= nc else p


def prefilter(xb, pos, pre: int, per_cell: int):
    nb, F, P, S = xb.shape
    dev = xb.device
    xb_p = xb[..., :per_cell].permute(0, 2, 1, 3).reshape(nb, P, F * per_cell)
    pos_p = pos[..., :per_cell].permute(0, 2, 1, 3).reshape(nb, P, F * per_cell)
    flat2 = (torch.arange(F * P, dtype=torch.int32, device=dev)[:, None] * S
             + torch.arange(per_cell, dtype=torch.int32, device=dev)).reshape(F, P, per_cell)
    flat_p = flat2.permute(1, 0, 2).reshape(1, P, F * per_cell).expand(nb, -1, -1)
    xb_s, order = torch.sort(xb_p, dim=-1, descending=True, stable=True)
    pos_s = torch.gather(pos_p, -1, order)
    flat_s = torch.gather(flat_p, -1, order)
    q = split_quota(pre, P)
    xb_sel = torch.cat([xb_s[:, p, : q[p]] for p in range(P)], dim=-1)
    pos_sel = torch.cat([pos_s[:, p, : q[p]] for p in range(P)], dim=-1)
    flat = torch.cat([flat_s[:, p, : q[p]] for p in range(P)], dim=-1)
    f_idx = torch.div(flat, P * S, rounding_mode="floor")
    p_idx = torch.div(flat % (P * S), S, rounding_mode="floor")
    return xb_sel, pos_sel.to(torch.int32), f_idx.to(torch.int32), p_idx.to(torch.int32), flat.to(torch.int32)


def _order_two_keys(nbad, xb, k: int):
    o1 = torch.sort(torch.clamp_min(xb, 0.0), dim=-1, descending=True, stable=True)[1]
    o2 = torch.sort(torch.gather(nbad, -1, o1), dim=-1, stable=True)[1]
    return torch.gather(o1, -1, o2)[..., :k]


def _order_one_key(nbad, xb, k: int, thr: int, mask=None):
    """The single-key order; rows outside `mask` are keyed 0 and rank last
    (real keys are > 0)."""
    cls = torch.clamp_max(nbad, thr + 1).to(torch.int32)
    key = torch.ldexp(torch.clamp(xb, _XB_LO, _XB_HI), -24 * cls)
    if mask is not None:
        key = torch.where(mask, key, torch.zeros((), dtype=key.dtype, device=key.device))
    return torch.sort(key, dim=-1, descending=True, stable=True)[1][..., :k]


def survivor_index(nbad, xb, s: Settings, p_idx=None):
    """(B, k) survivors of the rows (B, nc). With threshold <= 4 and
    k >= P > 1 a per-pattern quota: p_idx None means the prefilter's
    pattern-major rows (a slice a pattern, two keys), else p_idx (nc,) is
    each row's pattern on the whole grid (a mask a pattern, the single key)."""
    P = s.scan_depth
    nc = nbad.shape[-1]
    k = min(s.max_survivors, nc)
    thr = s.nbadsync_threshold
    if thr > TOPK_MAX_THRESHOLD:
        return _order_two_keys(nbad, xb, k)
    if not k >= P > 1:
        return _order_one_key(nbad, xb, k, thr)
    if p_idx is not None:
        parts = [_order_one_key(nbad, xb, q, thr, mask=p_idx == p)
                 for p, q in enumerate(split_quota(k, P))]
    else:
        offs = np.cumsum([0] + split_quota(nc, P))
        parts = [_order_two_keys(nbad[..., int(offs[p]):int(offs[p + 1])],
                                 xb[..., int(offs[p]):int(offs[p + 1])], q) + int(offs[p])
                 for p, q in enumerate(split_quota(k, P))]
    return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]


# --- survivor demod -----------------------------------------------------------

def demod_survivors(c, W, chi, pos, f_idx, p_idx, masks, sync_conj, pp12, sync_pm):
    """(softbits (B, S, 128), nbadsync (B, S)) of the prefiltered rows."""
    dev = c.device
    pos_l = pos.long()
    f = f_idx.long()
    q0 = torch.div(pos_l, 128, rounding_mode="floor")
    w_pos = W[f, 128 * q0] * W[f, pos_l - 128 * q0]
    t864 = W[f][..., :: C.FRAME_LEN][..., :_M]
    phi = torch.conj(1.0 + chi[f])
    mask = masks[p_idx.long()].to(W.dtype)
    g0 = mask * w_pos[..., None] * t864
    g1 = g0 * phi[..., None]
    gam = torch.stack([g0, g1, g1 * phi[..., None]], dim=-1)  # (B, S, 6, 3)
    m = torch.arange(_M, device=dev)[:, None] * C.FRAME_LEN
    lane = torch.arange(C.FRAME_LEN, device=dev)[None, :]
    idx = pos_l[..., None, None] + m + lane
    kk = torch.div(idx, _N, rounding_mode="floor")
    vals = torch.gather(c[:, None, :].expand(-1, idx.shape[1], -1), 2,
                        (idx - kk * _N).reshape(idx.shape[0], idx.shape[1], -1)).reshape(idx.shape)
    g = torch.gather(gam, -1, kk.reshape(idx.shape[:3] + (-1,))).reshape(idx.shape)
    frames = (vals * g).sum(dim=2) * W[f, : C.FRAME_LEN]
    return demod_frames(frames, sync_conj, pp12, sync_pm)


def demod_frames(frames, sync_conj, pp12, sync_pm):
    """(softbits (..., 128), nbadsync (...)) of frames (..., 864): the
    carrier phase from both sync regions, the derotated half-sine matched
    filter, the scaled data softbits and the sync word's bad bits."""
    dev = frames.device
    s = ((frames[..., :_TAPS] * sync_conj).sum(dim=-1)
         + (frames[..., C.SECOND_SYNC_SAMPLE: C.SECOND_SYNC_SAMPLE + _TAPS] * sync_conj).sum(dim=-1))
    phase0 = torch.atan2(s.imag, s.real)
    d = frames * torch.complex(torch.cos(phase0), -torch.sin(phase0))[..., None]
    qq = np.arange(72)[:, None]
    ii = np.arange(12)[None, :]
    idx_q = torch.from_numpy((858 + 12 * qq + ii) % C.FRAME_LEN).to(dev)
    idx_i = torch.from_numpy(12 * qq + ii).to(dev)
    sb = torch.stack([(d.imag[..., idx_q] * pp12).sum(dim=-1),
                      (d.real[..., idx_i] * pp12).sum(dim=-1)], dim=-1)
    sb = sb.reshape(d.shape[:-1] + (C.NUM_CHANNEL_BITS,))
    sav = sb.mean(dim=-1, keepdim=True)
    s2av = (sb * sb).mean(dim=-1, keepdim=True)
    ssig = torch.sqrt(torch.clamp_min(s2av - sav * sav, 1e-30))
    scale = 2.0 / (ssig * (C.SOFTBIT_SIGMA ** 2))
    soft = scale * torch.cat([sb[..., 8:56], sb[..., 64:144]], dim=-1)
    nbad = torch.zeros(sb.shape[:-1], dtype=torch.int32, device=dev)
    for base in (C.FIRST_SYNC_BIT, C.SECOND_SYNC_BIT):
        hard = torch.where(sb[..., base: base + 8] < 0.0, -1, 1).to(torch.int32)
        nbad = nbad + ((8 - (hard * sync_pm).sum(dim=-1)) // 2).to(torch.int32)
    return soft, nbad


def full_rows(xb, pos, P: int, k: int):
    """Every candidate of the grid as a row, in (F, P, k) order: (xb, pos)
    (B, nc), the flat index (B, nc) and each row's pattern (nc,)."""
    nb = xb.shape[0]
    nc = xb[0].numel()
    flat = torch.arange(nc, dtype=torch.int32, device=xb.device)
    p_idx = torch.div(flat % (P * k), k, rounding_mode="floor")
    return xb.reshape(nb, nc), pos.reshape(nb, nc), flat.expand(nb, -1), p_idx


def pattern_sums(z, depth: int):
    """(..., N) -> (..., P, N): each pattern's sum of the frames its mask
    keeps, sum_m mask_p[m] roll(z, -864 m); the patterns 0-5 as running
    sums, the gap patterns 6 = {0, 3} and 7 = {0, 3, 4} on their own, each
    summed in ascending m."""
    rolls = [torch.roll(z, -C.FRAME_LEN * m, dims=-1) for m in range(_M)]
    out = [rolls[0]]
    for m in range(1, _M):
        out.append(out[-1] + rolls[m])
    out.append(rolls[0] + rolls[3])
    out.append(out[-1] + rolls[4])
    return torch.stack(out[:depth], dim=-2)


def demod_all(c, W, pos, sync_conj, pp12, sync_pm):
    """(softbits (B, nc, 128), nbadsync (B, nc)) of every candidate pos
    (B, F, P, k), rows in (F, P, k) order: each window mixed down at each
    frequency, its pattern sums, each candidate's frame cut from its
    pattern's sum at its lag (wrapping), then the tail. Runs in blocks of
    (window, frequency) cells whose frames stay within _FULL_BLOCK_BYTES."""
    nb, F, P, k = pos.shape
    dev = c.device
    sb = torch.empty((nb, F, P, k, C.NUM_DATA_BITS), dtype=torch.float32, device=dev)
    nbad = torch.empty((nb, F, P, k), dtype=torch.int32, device=dev)
    cells = max(1, _FULL_BLOCK_BYTES // (P * k * C.FRAME_LEN * 8))
    wb = min(nb, cells)
    fb = max(1, min(F, cells // wb))
    lane = torch.arange(C.FRAME_LEN, device=dev)
    for w0 in range(0, nb, wb):
        for f0 in range(0, F, fb):
            za = pattern_sums(c[w0: w0 + wb, None, :] * W[f0: f0 + fb], P)
            zad = torch.cat([za, za[..., : C.FRAME_LEN - 1]], dim=-1)
            p = pos[w0: w0 + wb, f0: f0 + fb]
            idx = p.long()[..., None] + lane
            frames = torch.gather(zad, -1, idx.reshape(idx.shape[:3] + (-1,)))
            frames = frames.reshape(p.shape + (C.FRAME_LEN,))
            sb[w0: w0 + wb, f0: f0 + fb], nbad[w0: w0 + wb, f0: f0 + fb] = demod_frames(
                frames, sync_conj, pp12, sync_pm)
    return sb.reshape(nb, -1, C.NUM_DATA_BITS), nbad.reshape(nb, -1)


# --- LDPC ---------------------------------------------------------------------

def _div(x, d: float):
    return x / torch.full_like(x, d)


def platanh(x):
    z = torch.abs(x)
    s = torch.where(x < 0.0, -1.0, 1.0)
    return torch.where(
        z <= 0.664, _div(x, 0.83),
        s * torch.where(z <= 0.9217, _div(z - 0.4064, 0.322),
                        torch.where(z <= 0.9951, _div(z - 0.8378, 0.0524),
                                    torch.where(z <= 0.9998, _div(z - 0.9914, 0.0012), 7.0))))


def bp_decode(llr, valid, nm, mn_edge, crc, max_iters: int = C.NUM_BP_ITERATIONS):
    """(found, codeword, iterations) of rows llr (R, 128), valid (R,)."""
    R = llr.shape[0]
    dev = llr.device
    edge_valid = nm >= 0
    bit = nm.clamp_min(0).long()
    mn = mn_edge.long()
    hard_in = llr > 0.0
    tov = torch.zeros((R, T.N_CHECKS, T.MAX_ROW_DEGREE), dtype=torch.float32, device=dev)
    found = torch.zeros((R,), dtype=torch.bool, device=dev)
    cw_s = torch.zeros((R, T.N_BITS), dtype=torch.int8, device=dev)
    iter_s = torch.zeros((R,), dtype=torch.int32, device=dev)
    for it in range(max_iters):
        tflat = tov.reshape(R, -1)
        zn = llr + tflat[:, mn[:, 0]] + tflat[:, mn[:, 1]] + tflat[:, mn[:, 2]]
        cw = zn > 0.0
        cwi = cw.to(torch.int32)
        par = (cwi[:, bit] * edge_valid).sum(dim=-1) % 2
        crc_bits = (cwi[:, None, : C.NUM_MESSAGE_BITS] * crc).sum(dim=-1) % 2
        crc_ok = (crc_bits == cwi[:, C.NUM_MESSAGE_BITS: C.NUM_INFO_BITS]).all(dim=-1)
        nerr = (cw != hard_in).sum(dim=-1).to(torch.int32)
        ok = (par.sum(dim=-1) == 0) & crc_ok & (nerr < C.MAX_HARD_ERRORS) & valid
        newly = ok & ~found
        cw_s = torch.where(newly[:, None], cw.to(torch.int8), cw_s)
        iter_s = torch.where(newly, it, iter_s)
        found = found | newly
        toc = zn[:, bit] - tov
        t = torch.where(edge_valid, torch.tanh(-0.5 * toc), 1.0)
        lt = torch.log2(torch.clamp_min(torch.abs(t), _LOG_FLOOR))
        S = lt[..., 0]
        for j in range(1, lt.shape[-1]):
            S = S + lt[..., j]
        mag = torch.exp2(S[..., None] - lt)
        neg = ((t < 0.0) & edge_valid).to(torch.int32)
        others = neg.sum(dim=-1, keepdim=True) - neg
        loo = (1.0 - 2.0 * (others % 2).to(t.dtype)) * mag
        tov = torch.where(edge_valid, 2.0 * platanh(-loo), 0.0)
    return found, cw_s, iter_s


# --- the decode -----------------------------------------------------------------

class Rows(NamedTuple):
    """A batch's decoded rows on the host, (B, R) each: the survivors in
    rank order, decodes first, R = min(max_results, K)."""

    cand_index: np.ndarray
    found: np.ndarray
    message_bits: np.ndarray  # (B, R, 77) int8
    nbadsync: np.ndarray
    xb: np.ndarray
    pos: np.ndarray
    block_power: np.ndarray  # (B, 8)
    bp_updates: np.ndarray  # (B,) BP message updates the window's K rows needed


class ReferenceDecoder:
    """The device half of the reference: batches of raw windows to Rows."""

    def __init__(self, settings: Settings, device):
        self.s = settings
        self.device = torch.device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        s = settings
        self.B, self.E_dec, self.chi, self.W = freq_tables(s.freqs, s.scan_decimation, self.device)
        F = len(s.freqs)
        self.nc = F * s.scan_depth * s.candidates_per_pattern
        self.pre = prefilter_size(s, self.nc)  # 0: the full-demod path
        per_cell = s.prefilter_per_cell
        while per_cell < s.candidates_per_pattern and F * s.scan_depth * per_cell < self.pre:
            per_cell += 1
        self.per_cell = per_cell

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(self.device)

        self.sync_conj = put(np.conj(C.CB42), np.complex64)
        self.pp12 = put(C.PP12, np.float32)
        self.masks = put(C.PATTERN_MASKS, np.int32)
        self.sync_pm = put(C.SYNC_WORD_PM, np.int32)
        mn = T.MN.astype(np.int32)
        self.nm = put(T.NM, np.int32)
        self.mn_edge = put(mn[..., 0] * T.MAX_ROW_DEGREE + mn[..., 1], np.int32)
        self.crc = put(crc_mod.CRC_MATRIX, np.int32)

    @torch.no_grad()
    def powers(self, raw: np.ndarray) -> np.ndarray:
        """(B, 8) sub-block powers of raw windows (B, N) int16."""
        return block_powers(analytic(torch.from_numpy(raw).to(self.device))).cpu().numpy()

    @torch.no_grad()
    def decode(self, raw: np.ndarray) -> Rows:
        s = self.s
        c = analytic(torch.from_numpy(raw).to(self.device))
        pos, xb = scan(c, self.B, self.E_dec, self.chi, s.scan_depth,
                       s.candidates_per_pattern, s.scan_decimation)
        if self.pre:
            xb_f, pos_f, f_idx, p_idx, flat = prefilter(xb, pos, self.pre, self.per_cell)
            sb, nbad = demod_survivors(c, self.W, self.chi, pos_f, f_idx, p_idx, self.masks,
                                       self.sync_conj, self.pp12, self.sync_pm)
            top = survivor_index(nbad, xb_f, s)
        else:
            xb_f, pos_f, flat, p_idx = full_rows(xb, pos, s.scan_depth, s.candidates_per_pattern)
            sb, nbad = demod_all(c, self.W, pos, self.sync_conj, self.pp12, self.sync_pm)
            top = survivor_index(nbad, xb_f, s, p_idx)
        llr = torch.gather(sb, 1, top[..., None].expand(-1, -1, sb.shape[-1]))
        nbad_k = torch.gather(nbad, 1, top)
        valid = nbad_k <= s.nbadsync_threshold
        b, k = valid.shape
        found, cw, iters = (a.reshape((b, k) + a.shape[1:]) for a in bp_decode(
            llr.reshape(b * k, -1), valid.reshape(-1), self.nm, self.mn_edge, self.crc))
        updates = torch.where(found, iters,
                              torch.where(valid, C.NUM_BP_ITERATIONS, 0)).sum(dim=-1)
        r = min(s.max_results, k)
        sel = torch.sort((~found).to(torch.int32), dim=-1, stable=True)[1][:, :r]

        def take(a):
            return torch.gather(a, 1, sel).cpu().numpy()

        bits = torch.gather(cw[..., : C.NUM_MESSAGE_BITS], 1,
                            sel[..., None].expand(-1, -1, C.NUM_MESSAGE_BITS))
        return Rows(cand_index=take(torch.gather(flat, 1, top)), found=take(found),
                    message_bits=bits.cpu().numpy(), nbadsync=take(nbad_k),
                    xb=take(torch.gather(xb_f, 1, top)), pos=take(torch.gather(pos_f, 1, top)),
                    block_power=block_powers(c).cpu().numpy(),
                    bp_updates=updates.cpu().numpy())


# --- host post-processing ---------------------------------------------------------

class SNRTracker:
    """Noise floor over the 8 sub-block powers: rises by a 0.9/0.1 EMA,
    falls at once; SNR = 10 log10(peak / noise - 1) in [-8, 24] dB,
    truncated toward zero."""

    def __init__(self) -> None:
        self.noise = 0.0
        self.snr = 0.0

    def update(self, powers: np.ndarray) -> int:
        """Take one window's 8 sub-block powers; its SNR."""
        arr = np.asarray(powers, dtype=np.float64)
        return self.update_from(float(arr.mean()), float(arr.max()))

    def update_from(self, avg: float, peak: float) -> int:
        """Take one window's mean and peak sub-block power; its SNR."""
        if self.noise <= 0.0:
            self.noise = avg
        elif avg > self.noise:
            self.noise = 0.9 * self.noise + 0.1 * avg
        else:
            self.noise = avg
        if self.noise > 0.0:
            ratio = peak / self.noise - 1.0
            self.snr = 10.0 * math.log10(ratio) if ratio > 0.0 else -8.0
        else:
            self.snr = 0.0
        self.snr = min(24.0, max(-8.0, self.snr))
        return int(self.snr)


def window_lines(s: Settings, rows: Rows, b: int, snr: int,
                 hashes: msg77.CallsignHashTable) -> List[str]:
    """The decode lines of window b (without their date field): every found
    row whose payload unpacks, deduplicated by text, keeping the lowest
    (num_avg, nbadsync), sorted by text."""
    per_f = s.scan_depth * s.candidates_per_pattern
    best = {}
    for k in np.nonzero(rows.found[b])[0]:
        bits = rows.message_bits[b][k]
        if not msg77.plausible_message_type(bits):
            continue
        ok, text = msg77.unpack77(bits, hashes)
        if not ok:
            continue
        fi, rem = divmod(int(rows.cand_index[b][k]), per_f)
        pi = rem // s.candidates_per_pattern
        item = (int(C.PATTERN_NUM_AVG[pi]), int(rows.nbadsync[b][k]), pi, float(s.freqs[fi]))
        if text not in best or item[:2] < best[text][:2]:
            best[text] = item
    return [line_text(snr, f0, num_avg, nbad, pi, text)
            for text, (num_avg, nbad, pi, f0) in sorted(best.items())]


def line_text(snr: int, f0: float, num_avg: int, nbadsync: int, pattern_idx: int,
              message: str) -> str:
    """A decode line as the decoder prints it, without the date field."""
    return (f"snr={snr:2d}; f0={f0:6g}; num_avg={num_avg}; nbadsync={nbadsync}; "
            f"pattern_idx={pattern_idx}; msg='{message}'")
