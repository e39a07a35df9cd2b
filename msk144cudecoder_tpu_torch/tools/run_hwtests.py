"""On-card validation battery of the PyTorch port, pinned as evidence.

Run from the repository root on a machine with a CUDA card and nvcc:

    python -m msk144cudecoder_tpu_torch.tools.run_hwtests

The port of the JAX package's tools/run_hwtests.py; it imports neither jax
nor the JAX package. Without a card it exits 1. Each step records
{ok, seconds, ...}; a step that raises is recorded as failed with its
error, the remaining steps still run, and any failed step fails the battery
(exit 2):

  gpu_tests    tests/test_torch_gpu.py in a subprocess (pytest --noconftest):
               0 failed, 0 skipped, at least GPU_TESTS_MIN passed
  kernels      B1-B4 against their plain versions at chip_smoke.py phase 2's
               shapes, by the agreement rules of PERF.md section 6, in
               float32 and in the bf16 fast_math mode (its fast
               instantiations against the fast plain versions)
  busyband     the four-ping pileup: prefilter 0 and K = 4848 decodes each
               ping at (num_avg, nbadsync) = (1, 0); at K = 256 the exact
               overflow warning and the same per-message result; the
               prefilter path at K = 256 equal to the CPU run
  cli          the demo through the CLI with the prefilter on and off,
               window by window and pipelined: lines equal to --device=cpu's;
               with --fast-math (the bf16 mode) the messages of the fp32 run
  mesh         MeshDecoder on cuda:0 x 4 at (1, 4) and (2, 2): decode
               summaries equal to the CPU's
  inputs       IQ input (--read-mode=2) and the FFT Hilbert transform
               (--analytic-method=1) through the CLI: the planted messages,
               lines equal to --device=cpu's
  sensitivity  the sweep's protocol on the card and on the CPU's plain path:
               the same decoded trials at every SNR down to -6 dB, at most
               one trial apart at -8 dB
  soak         the streaming soak through the CLI: the asserts of
               tests/test_soak.py, lines equal to --device=cpu's
  precision    the bf16 mode (DecoderConfig(fast_math=True)) against float32,
               card against card, by the bar the JAX package's fast_math
               met (msk144cudecoder_tpu/config.py:82-87): the sweep's
               protocol with the same decoded trials down to -6 dB and at
               most one apart at -8 dB; the busy band with the prefilter
               off and K = the whole grid with per-message (num_avg,
               nbadsync) equal, and at K = 256 with the prefilter on the
               same decodes; in fast mode, the demo's three messages with a
               summary equal to the CPU's fast plain path, and the -4 dB
               deep-scan decode; a fast pass launches only the fast kernels
  graph        the CUDA graphs (ops/graphs.py) against the eager pipeline on
               the demo and the busy band, in float32 and bf16, at B = 1 and
               64: every field of two consecutive replays on different
               inputs equal bit for bit to the eager forward's, the replays'
               buffers distinct, and a replay's launches those of one eager
               pass; the throughput CLI with --fast-math (a graph per
               worker) prints the lines of the window-by-window --fast-math
               run

It writes tests/data/hwtests_gpu.json (the card's name and power limit from
nvidia-smi, the torch, CUDA and nvcc versions, every step, the provenance
stamp of runtime/evidence.py, ok) and prints the same record as its last
line. tests/test_torch_hw.py fails on the CPU when the pinned record is not
green or its ops_hash is not the tree's: after an edit to a hashed file,
re-run this on the H100 and commit the JSON.

chip_smoke.py runs the checks it shares with the battery (the kernels
against their plain versions, the busy band, the CLI lines, MeshDecoder
parity, the input paths) through the functions here.
"""

from __future__ import annotations

import contextlib
import io
import json
import pathlib
import re
import subprocess
import sys
import tempfile
import time
import traceback
import xml.etree.ElementTree as ET

import numpy as np
import torch

from .. import constants as C
from .. import stimulus
from ..config import DecoderConfig
from ..ops import demod, graphs, kernels, ldpc, pipeline, scan, survivor
from ..parallel import MeshDecoder, make_mesh
from ..parallel.sharding import stream_to_windows
from ..protocol import crc as crc_mod
from ..protocol import ldpc_tables, msg77
from ..runtime import StreamDecoder
from ..runtime.decoder import to_host
from ..runtime.evidence import provenance
from . import sensitivity_sweep

ROOT = pathlib.Path(__file__).resolve().parents[2]
DEMO = ROOT / "demo" / "capture.raw"
EVIDENCE = ROOT / "tests" / "data" / "hwtests_gpu.json"
DEVICE = "cuda:0"
DEMO_MESSAGES = {"CQ K1ABC FN42", "K1ABC W9XYZ EN37", "W9XYZ K1ABC RR73"}
DEEP = DecoderConfig(search_width=500.0, search_step=1.0, scan_depth=6, nbadsync_threshold=3)
BUSY = DecoderConfig(search_width=200.0, search_step=2.0, scan_depth=6, nbadsync_threshold=3,
                     max_survivors=256)
GPU_TESTS_MIN = 66
NEAR_FAST = 2.0 ** -8  # one bf16 ulp at 1: a fast sync softbit this near 0 may flip
MESH_SHAPES = ((1, 4), (2, 2))
# IQ input: two messages at offsets around the 0 Hz centre, inside the
# default 200 Hz width
IQ_MESSAGES = [("CQ K1ABC FN42", -40.0), ("K1ABC W9XYZ EN37", 36.0)]
SOAK_FLAGS = ("--search-width=100", "--scan-depth=6", "--nbadsync-threshold=2")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def nvcc_version() -> str:
    out = subprocess.run([kernels.find_nvcc(), "--version"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[-1]


def strip_date(text: str) -> list[str]:
    return [re.sub(r"date=\d+;", "date=;", ln) for ln in text.splitlines()]


def messages(stdout: str) -> set[str]:
    return {m.group(1) for m in re.finditer(r"msg='([^']*)'", stdout)}


def run_cli(device: str, stdin_path: pathlib.Path, *flags: str) -> tuple[str, str]:
    """`python -m msk144cudecoder_tpu_torch --device=<device> <flags>` on a
    file; it must exit 0. Returns (stdout, stderr)."""
    with open(stdin_path, "rb") as fin:
        proc = subprocess.run(
            [sys.executable, "-m", "msk144cudecoder_tpu_torch", f"--device={device}", *flags],
            stdin=fin, capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert proc.returncode == 0, (device, flags, proc.returncode, proc.stderr[-3000:])
    return proc.stdout, proc.stderr


def survivor_warning(stderr: str) -> str:
    """The first survivor-overflow warning line, or ""."""
    return next((ln for ln in stderr.splitlines() if "sync survivors exceed" in ln), "")


def decode_best(decoder, windows: np.ndarray) -> dict:
    """message -> lowest (num_avg, nbadsync, f0) over a batch of windows."""
    best: dict = {}
    for items in decoder.decode_many(windows):
        for r in items:
            key = (r.num_avg, r.nbadsync, r.f0)
            if r.message not in best or key[:2] < best[r.message][:2]:
                best[r.message] = key
    return best


def mesh_summary(cfg, freqs, res) -> list[dict]:
    """Per window: message -> the lowest (num_avg, nbadsync, f0) of its found
    rows (the row the CLI prints); freqs is the grid the candidate indices
    refer to."""
    out = []
    hashes = msg77.CallsignHashTable()
    for b in range(res.found.shape[0]):
        best = {}
        for k in np.nonzero(res.found[b])[0]:
            ok, text = msg77.unpack77(pipeline.unpack_message_bits(res.message_bits[b][k]),
                                      hashes)
            if ok:
                fi, pi, _ = pipeline.unpack_candidate_index(cfg, int(res.cand_index[b][k]))
                key = (int(C.PATTERN_NUM_AVG[pi]), int(res.nbadsync[b][k]), float(freqs[fi]))
                best[text] = min(best.get(text, key), key)
        out.append(best)
    return out


# ---- kernels against their plain versions (chip_smoke.py phase 2) ----------

# (config, windows): the main path's batch of 64 windows (default and deep),
# one window, the earlier small batches, dec 1
SCAN_CASES = ((DecoderConfig(), 64), (DEEP, 64), (DecoderConfig(), 1), (DecoderConfig(), 8),
              (DEEP, 8), (DecoderConfig(scan_decimation=1), 4))
# (config, windows, plant): the main path's survivor rows of 64 windows, and
# 16 windows with wrap positions and gap patterns planted in every window
SURVIVOR_CASES = ((DecoderConfig(), 64, False), (DEEP, 64, False), (DecoderConfig(), 16, True))
# (config, windows) of the full-demod path, lags planted at the wrap points
DEMOD_CASES = ((DEEP, 64), (DecoderConfig(), 8), (DEEP, 2),
               (DecoderConfig(scan_depth=8, candidates_per_pattern=5), 2))
DEMOD_WRAPS = (0, 863, 864, 4320, 4321, 5183, 2591, 5000)


def demo_windows() -> np.ndarray:
    return stimulus.stream_windows(np.fromfile(DEMO, dtype=np.int16))


def kernel_windows(cfg, n: int, rng, dev, noise: bool = True):
    """A pipeline for cfg on dev and n analytic windows: the demo's in turn,
    the last quarter noise drawn from rng unless noise is False."""
    windows = demo_windows()
    n_noise = n // 4 if noise else 0
    raws = [windows[i % len(windows)] for i in range(n - n_noise)]
    raws += [rng.normal(0, 1000, C.WINDOW_LEN).astype(np.int16) for _ in range(n_noise)]
    pipe = pipeline.DecodePipeline(cfg).to(dev)
    return pipe, pipe.preprocess(torch.from_numpy(np.stack(raws)).to(dev))


TIED_PATTERNS = (5, 6)  # their metrics repeat every 864 and 2592 samples: slice maxima tie


def check_scan(pipe, c) -> tuple[dict, tuple]:
    """Kernel B1 against scan_plain, in the pipeline's precision: xb within
    1e-4; positions on the coarse grid, equal in >= 99 % of the slots of
    every pattern but the all-frames pattern 5 and the gap pattern 6 (depth
    > 6), whose slice maxima tie by construction; every unequal slot a near
    tie (the two xb within 1e-4 relative). The bf16 kernel's tensor cores add
    each k-step's products in an order of their own, so it too agrees with
    the plain version to float32 rounding, not bit for bit. Returns
    (agreement statistics, the kernel's arguments)."""
    cfg = pipe.cfg
    depth, dec = cfg.scan_depth, cfg.scan_decimation
    args = (c, pipe.B, pipe.E_dec, pipe.chi, depth, cfg.candidates_per_pattern, dec,
            cfg.fast_math)
    pos_k, xb_k = scan.scan_cuda(*args)
    pos_p, xb_p = scan.scan_plain(*args)
    pk, pp = pos_k.cpu().numpy(), pos_p.cpu().numpy()
    xk, xp = xb_k.cpu().numpy(), xb_p.cpu().numpy()
    mism = pk != pp
    near = np.abs(xk - xp) <= 1e-4 * np.abs(xp)
    untied = [p for p in range(depth) if p not in TIED_PATTERNS]
    agree = [1.0 - float(mism[:, :, p].mean()) for p in untied]
    stats = dict(pos_agree_min=min(agree), near_ties=int(mism.sum()),
                 max_abs_err=float(np.abs(xk - xp).max()))
    np.testing.assert_allclose(xk, xp, rtol=1e-4, atol=1e-4)
    assert (pk % dec == 0).all() and (pk >= 0).all() and (pk < C.WINDOW_LEN).all()
    assert min(agree) >= 0.99 and bool(near[mism].all()), stats
    return stats, args


def check_survivor(pipe, c, plant: bool) -> tuple[dict, tuple, tuple]:
    """Kernel B2 against demod_survivors_plain on the prefilter's rows (with
    wrap lags and gap patterns planted in the first 8 rows of each window
    when plant), in the pipeline's precision: softbits within 5e-3 relative
    (|d| / (|ref| + 1e-3)); nbadsync identical in float32, and in fast mode
    unequal only where a plain sync softbit lies within one bf16 ulp
    (NEAR_FAST) of 0. Returns (statistics, arguments, outputs)."""
    dev = c.device
    front = pipe.prefilter(*pipe.scan(c))
    pos_f, f_idx, p_idx = (t.clone() for t in front[1:4])
    if plant:
        pos_f[:, :8] = torch.tensor([5000, 5183, 4321, 3500, 0, 2591, 5180, 4400],
                                    dtype=torch.int32, device=dev)
        p_idx[:, :8] = torch.tensor([6, 7, 6, 7, 5, 3, 0, 7], dtype=torch.int32, device=dev)
        f_idx[:, :8] = torch.tensor([0, 100, 50, 7, 99, 1, 60, 33], dtype=torch.int32,
                                    device=dev)
    fast = pipe.cfg.fast_math
    args = (c, pipe.W, pipe.chi, pos_f, f_idx, p_idx, pipe.demod_tables, fast)
    sb_k, nb_k = survivor.demod_survivors_cuda(*args)
    sb_p, nb_p = survivor.demod_survivors_plain(*args)
    n_mism, near = survivor.nbadsync_agreement(*args[:7], nb_k, nb_p, NEAR_FAST, fast)
    stats = dict(rows=int(nb_k.numel()), nbadsync_unequal=n_mism, unequal_near_zero=near,
                 max_rel=((sb_k - sb_p).abs() / (sb_p.abs() + 1e-3)).max().item(),
                 max_abs_err=(sb_k - sb_p).abs().max().item())
    assert (n_mism == 0) if not fast else near, stats
    assert stats["max_rel"] < 5e-3, stats
    assert torch.isfinite(sb_k).all()
    return stats, args, (sb_k, nb_k)


def bp_inputs(rng, dev, fast: bool = False) -> list:
    """(tag, llr, valid, tables) of kernel B3's cases: the main path's own
    rows (in the given precision), the selected survivors of 64 demo windows
    (16,384 rows); then 4096 rows, three quarters planted codewords with
    noise, a quarter noise, every fourth row marked invalid."""
    pipe, c = kernel_windows(DecoderConfig(fast_math=fast), 64, rng, dev, noise=False)
    front = pipe.prefilter(*pipe.scan(c))
    prep = pipe.select(*pipe.demod(c, front), front)
    rows = []
    for _ in range(3072):
        msg = rng.integers(0, 2, 77)
        cw = ldpc_tables.encode(np.concatenate([msg, (crc_mod.CRC_MATRIX @ msg) % 2]))
        rows.append((2.0 * cw - 1.0) * rng.uniform(1.5, 4.0) + rng.normal(0, 1.0, 128))
    rows += [rng.normal(0, 2.0, 128) for _ in range(1024)]
    lt = pipe.ldpc_tables
    return [("main-path rows", prep.llr.reshape(-1, C.NUM_DATA_BITS).contiguous(),
             prep.valid.reshape(-1).contiguous(), lt),
            ("planted rows", torch.from_numpy(np.stack(rows).astype(np.float32)).to(dev),
             torch.from_numpy(np.arange(4096) % 4 != 3).to(dev), lt)]


def check_bp(tag: str, llr, valid, lt, fast: bool = False) -> tuple[dict, tuple]:
    """Kernel B3 against bp_decode_plain, in float32 or fast: every output
    identical in float32, found and codeword identical on every row in
    fast mode; rows found (over 1000 of the planted rows). Returns
    (statistics, outputs)."""
    r_k = ldpc.bp_decode_cuda(llr, valid, lt, fast=fast)
    r_p = ldpc.bp_decode_plain(llr, valid, lt, fast=fast)
    unequal = [f for f in r_k._fields if not torch.equal(getattr(r_k, f), getattr(r_p, f))]
    stats = dict(rows=int(llr.shape[0]), valid=int(valid.sum()), found=int(r_k.found.sum()),
                 unequal_outputs=unequal,
                 max_abs_err=float((r_k.codeword.int() - r_p.codeword.int()).abs().max()))
    assert not set(unequal) & ({"found", "codeword"} if fast else set(r_k._fields)), (tag, stats)
    assert stats["found"] > (1000 if tag == "planted rows" else 0), (tag, stats)
    return stats, r_k


def check_demod(pipe, c) -> tuple[dict, tuple, list, tuple]:
    """Kernel B4 against demod_candidates_plain on every scan candidate, lags
    planted at the window's wrap points, the plain version 4 windows at a
    time, in the pipeline's precision: softbits within 5e-3 relative;
    nbadsync equal on >= 99.99 % of rows, every unequal row with a plain
    sync softbit within 1e-3 of 0 (in fast mode NEAR_FAST, one bf16 ulp).
    Returns (statistics, arguments, the plain version's chunked arguments,
    outputs)."""
    nw = c.shape[0]
    fast = pipe.cfg.fast_math
    pos = pipe.scan(c)[0].contiguous()
    pos.view(nw, -1)[:, : len(DEMOD_WRAPS)] = torch.tensor(DEMOD_WRAPS, dtype=torch.int32,
                                                           device=c.device)
    args = (c, pipe.W, pos, pipe.demod_tables, fast)
    sb_k, nb_k = demod.demod_candidates_cuda(*args)
    assert torch.isfinite(sb_k).all()
    chunks = [(c[lo:lo + 4], pipe.W, pos[lo:lo + 4].contiguous(), pipe.demod_tables, fast)
              for lo in range(0, nw, 4)]
    rel, err, n_mism, near = 0.0, 0.0, 0, True
    for lo, a in zip(range(0, nw, 4), chunks):
        sb_p, nb_p = demod.demod_candidates_plain(*a)
        d = (sb_k[lo:lo + 4] - sb_p).abs()
        rel = max(rel, (d / (sb_p.abs() + 1e-3)).max().item())
        err = max(err, d.max().item())
        _, n, ok = demod.nbadsync_agreement(*a[:4], nb_k[lo:lo + 4], nb_p,
                                            near=NEAR_FAST if fast else 1e-3, fast=fast)
        n_mism, near = n_mism + n, near and ok
        del sb_p, nb_p, d
    stats = dict(rows=int(nb_k.numel()), max_rel=rel, max_abs_err=err,
                 nbadsync_equal_share=1.0 - n_mism / nb_k.numel(), nbadsync_unequal=n_mism,
                 unequal_near_zero=bool(near))
    assert rel < 5e-3, stats
    assert stats["nbadsync_equal_share"] >= 0.9999 and near, stats
    return stats, args, chunks, (sb_k, nb_k)


def fast_cases(cases) -> tuple:
    """The bf16 (fast_math) counterparts of kernel cases (config first)."""
    return tuple((cfg.replace(fast_math=True), *rest) for cfg, *rest in cases)


# the fast instantiations at every shape of their float32 cases: B1; B2 on
# the main path's 64 windows, default and deep, and with wrap lags and gap
# patterns planted; B4 on the deep scan's 64 windows, the default grid's 8,
# 2 windows of the deep grid, and depth 8 (gap patterns 6 and 7) with k = 5,
# lags planted at the window's wrap points in each (B3 on the fast main
# path's rows: bp_inputs(fast=True))
FAST_SCAN_CASES = fast_cases(SCAN_CASES)
FAST_SURVIVOR_CASES = fast_cases(SURVIVOR_CASES)
FAST_DEMOD_CASES = fast_cases(DEMOD_CASES)


def mode(cfg) -> str:
    return " bf16" if cfg.fast_math else ""


def scan_name(cfg, nw: int) -> str:
    return (f"scan F={cfg.num_freqs} depth={cfg.scan_depth} dec={cfg.scan_decimation} B={nw}"
            + mode(cfg))


def survivor_name(cfg, nw: int, rows: int, plant: bool) -> str:
    return (f"survivor F={cfg.num_freqs} depth={cfg.scan_depth} B={nw} S={rows}"
            + (" (wrap lags, gap patterns planted)" if plant else "") + mode(cfg))


def bp_name(tag: str, rows: int, fast: bool) -> str:
    return f"bp R={rows} ({tag})" + (" bf16" if fast else "")


def demod_name(cfg, nw: int, rows: int) -> str:
    return (f"demod F={cfg.num_freqs} depth={cfg.scan_depth} k={cfg.candidates_per_pattern} "
            f"B={nw} ({rows} rows)" + mode(cfg))


def step_kernels(rec: dict) -> None:
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(2026)
    for cfg, nw in SCAN_CASES + FAST_SCAN_CASES:
        pipe, c = kernel_windows(cfg, nw, rng, dev)
        rec[scan_name(cfg, nw)], _ = check_scan(pipe, c)
    for cfg, nw, plant in SURVIVOR_CASES + FAST_SURVIVOR_CASES:
        pipe, c = kernel_windows(cfg, nw, rng, dev)
        stats, args, _ = check_survivor(pipe, c, plant)
        rec[survivor_name(cfg, nw, args[3].shape[1], plant)] = stats
    for fast in (False, True):
        for tag, llr, valid, lt in bp_inputs(rng, dev, fast):
            rec[bp_name(tag, llr.shape[0], fast)], _ = check_bp(tag, llr, valid, lt, fast)
    for cfg, nw in DEMOD_CASES + FAST_DEMOD_CASES:
        pipe, c = kernel_windows(cfg.replace(survivor_prefilter=0), nw, rng, dev)
        stats = check_demod(pipe, c)[0]
        rec[demod_name(pipe.cfg, nw, stats["rows"])] = stats
        torch.cuda.empty_cache()
    for name, stats in rec.items():
        log(f"[kernels] {name}: {stats}")


# ---- end-to-end checks --------------------------------------------------------

def busy_band(rec: dict, dev) -> None:
    """The four-ping pileup (width 200, depth 6, nbadsync 3). The prefilter
    path at K = 256 decodes all four with per-message (num_avg, nbadsync)
    equal to the CPU run, and warns "at least"; with the prefilter off and
    K = 4848 (every candidate) each ping decodes at (1, 0) within one step
    of its frequency, and at K = 256 the warning gives the exact count with
    the same per-message result."""
    windows = stimulus.stream_windows(stimulus.busy_band_audio())
    want = {p[0] for p in stimulus.BUSY_BAND_PINGS}
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        best = decode_best(StreamDecoder(BUSY, dev), windows)
    with contextlib.redirect_stderr(io.StringIO()):
        best_cpu = decode_best(StreamDecoder(BUSY, "cpu"), windows)
    rec["prefilter_k256"] = {m: list(v) for m, v in sorted(best.items())}
    rec["prefilter_k256_cpu"] = {m: list(v) for m, v in sorted(best_cpu.items())}
    rec["prefilter_k256_warning"] = survivor_warning(err.getvalue())
    full = {}
    for k in (BUSY.num_candidates, 256):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            full[k] = decode_best(
                StreamDecoder(BUSY.replace(survivor_prefilter=0, max_survivors=k), dev), windows)
        rec[f"full_k{k}"] = {m: list(v) for m, v in sorted(full[k].items())}
        rec[f"full_k{k}_warning"] = survivor_warning(err.getvalue())
    assert set(best) == want, best
    assert {m: v[:2] for m, v in best.items()} == {m: v[:2] for m, v in best_cpu.items()}, (
        best, best_cpu)
    assert rec["prefilter_k256_warning"].startswith("Warning: at least"), rec
    full_all = full[BUSY.num_candidates]
    assert set(full_all) == want and set(full[256]) == want, full
    for text, f0, *_ in stimulus.BUSY_BAND_PINGS:
        na, nbad, f_dec = full_all[text]
        assert (na, nbad) == (1, 0) and abs(f_dec - f0) <= BUSY.search_step, (text, full_all)
    assert {m: v[:2] for m, v in full[256].items()} == {m: v[:2] for m, v in full_all.items()}
    warning = rec["full_k256_warning"]
    assert warning.startswith("Warning: ") and "at least" not in warning, warning


def demo_cli(rec: dict, *flags: str) -> str:
    """The demo through the CLI with `flags` on the card, window by window
    and pipelined (--window-batch=8 --pipeline-depth=4), and with
    --device=cpu: the three planted messages, every line equal but for
    date=. Returns the card's window-by-window stdout."""
    out, err = run_cli(DEVICE, DEMO, *flags)
    out_cpu, _ = run_cli("cpu", DEMO, *flags)
    out_b, err_b = run_cli(DEVICE, DEMO, "--window-batch=8", "--pipeline-depth=4", *flags)
    rec.update(lines=len(strip_date(out)) - 1, messages=sorted(messages(out)),
               warning=survivor_warning(err), equal_to_cpu=strip_date(out) == strip_date(out_cpu),
               pipelined_equal=strip_date(out_b) == strip_date(out))
    assert messages(out) == DEMO_MESSAGES, rec
    assert rec["equal_to_cpu"], (out, out_cpu)
    assert rec["pipelined_equal"], (out_b, out)
    assert "Throughput:" in err_b, err_b[-2000:]
    return out


def mesh_parity(rec: dict, cfg, windows: np.ndarray, n_time: int, n_freq: int, dev) -> None:
    """MeshDecoder on [dev] * n_time * n_freq against MeshDecoder on the CPU
    at the same mesh, 4 windows per call (the CPU's plain path's memory):
    the decode summaries are equal, the path's kernels launch, and the
    unsharded pipeline's messages are among the sharded ones."""
    n = n_time * n_freq

    def chunked(md):
        out = []
        for lo in range(0, len(windows), 4):
            out += mesh_summary(md.cfg, md.freqs, md.decode(windows[lo:lo + 4]))
        return out

    md = MeshDecoder(cfg, make_mesh(n_time, n_freq, [dev] * n))
    kernels.reset_launch_counts()
    got = chunked(md)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = chunked(MeshDecoder(cfg, make_mesh(n_time, n_freq, ["cpu"] * n)))
    pipe = pipeline.DecodePipeline(cfg).to(dev)
    unsharded = set()
    for lo in range(0, len(windows), 4):
        res = to_host(pipe(torch.from_numpy(windows[lo:lo + 4]).to(dev)))
        unsharded |= {m for s in mesh_summary(cfg, cfg.freqs, res) for m in s}
    sharded = {m for s in got for m in s}
    rec.update(equal_to_cpu=got == want, messages=sorted(sharded),
               unsharded=sorted(unsharded), launches=counts)
    assert got == want, (got, want)
    demod_kernel = "survivor" if cfg.survivor_prefilter is None else "demod"
    assert all(counts[k] > 0 for k in ("scan", demod_kernel, "bp")), counts
    assert unsharded and unsharded <= sharded, (unsharded, sharded)


def mesh_cases():
    """(name, config, windows) of the mesh step: the demo and the busy band,
    with the prefilter on and off."""
    for name, base, windows in (("demo", DecoderConfig(), demo_windows()),
                                ("busy", BUSY, stimulus.stream_windows(stimulus.busy_band_audio()))):
        for pre in (None, 0):
            yield f"{name} prefilter {'auto' if pre is None else pre}", \
                base.replace(survivor_prefilter=pre), windows


def iq_stimulus() -> np.ndarray:
    """Interleaved int8 IQ of IQ_MESSAGES, 12 frames (3 windows)."""
    return stimulus.synthesize_iq_int8(IQ_MESSAGES, 12, snr_db=8.0, rng=np.random.default_rng(21))


def input_paths(rec: dict, dev, tmp: pathlib.Path) -> None:
    """IQ input (read mode 2: two messages around 0 Hz) and the FFT Hilbert
    transform (analytic method 1, on the demo) through the CLI on the card
    and with --device=cpu: the planted messages, each within one step of
    its frequency on IQ, every line equal but for date=. Then each path in
    this process through StreamDecoder, with the launch counts set to 0
    just before it and read just after: the scan, survivor and BP kernels
    launch."""
    iq = iq_stimulus()
    iq_path = tmp / "iq.raw"
    iq_path.write_bytes(iq.tobytes())
    cases = (("iq", iq_path, ("--read-mode=2",), {m for m, _ in IQ_MESSAGES},
              DecoderConfig.create(read_mode=2), stream_to_windows(iq, 2)),
             ("analytic_method_1", DEMO, ("--analytic-method=1",), DEMO_MESSAGES,
              DecoderConfig(analytic_method=1), demo_windows()))
    for tag, path, flags, want, cfg, windows in cases:
        out, _ = run_cli(DEVICE, path, *flags)
        out_cpu, _ = run_cli("cpu", path, *flags)
        r = rec[tag] = dict(lines=len(strip_date(out)) - 1, messages=sorted(messages(out)),
                            equal_to_cpu=strip_date(out) == strip_date(out_cpu))
        decoder = StreamDecoder(cfg, dev)
        kernels.reset_launch_counts()
        with contextlib.redirect_stderr(io.StringIO()):
            best = decode_best(decoder, windows)
        torch.cuda.synchronize()
        r.update(launches=kernels.launch_counts(),
                 in_process={m: list(v) for m, v in sorted(best.items())})
        assert messages(out) == want, (tag, out)
        assert r["equal_to_cpu"], (tag, out, out_cpu)
        assert set(best) == want, (tag, best)
        assert all(r["launches"][k] > 0 for k in ("scan", "survivor", "bp")), (tag, r)
        if tag == "iq":
            for ln in out.splitlines():
                if "msg='" in ln:
                    f0 = float(re.search(r"f0=\s*(-?[0-9.]+)", ln).group(1))
                    planted = dict(IQ_MESSAGES)[re.search(r"msg='([^']*)'", ln).group(1)]
                    assert abs(f0 - planted) <= cfg.search_step, ln


# ---- the battery's steps -------------------------------------------------------

def step_gpu_tests(rec: dict) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        xml = pathlib.Path(tmp) / "gpu.xml"
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", "--noconftest", "tests/test_torch_gpu.py", "-q",
             "-p", "no:cacheprovider", f"--junitxml={xml}"],
            capture_output=True, text=True, cwd=ROOT, timeout=1200)
        log(proc.stdout[-3000:] + proc.stderr[-2000:])
        root = ET.parse(xml).getroot()
    suite = root if root.tag == "testsuite" else root.find("testsuite")
    n = {k: int(suite.get(k, 0)) for k in ("tests", "failures", "errors", "skipped")}
    rec.update(rc=proc.returncode, passed=n["tests"] - n["failures"] - n["errors"] - n["skipped"],
               failed=n["failures"] + n["errors"], skipped=n["skipped"])
    assert rec["rc"] == 0 and rec["failed"] == 0 and rec["skipped"] == 0, rec
    assert rec["passed"] >= GPU_TESTS_MIN, rec


def step_busyband(rec: dict) -> None:
    busy_band(rec, torch.device(DEVICE))
    log(f"[busyband] {rec}")


def step_cli(rec: dict) -> None:
    for tag, flags in (("prefilter_auto", ()), ("prefilter_0", ("--survivor-prefilter=0",))):
        demo_cli(rec.setdefault(tag, {}), *flags)
        log(f"[cli] {tag}: {rec[tag]}")
    rec["fast_math"] = fast_math_cli()
    log(f"[cli] fast_math: {rec['fast_math']}")


def fast_math_cli() -> dict:
    """The demo through the CLI on the card, window by window, with
    --fast-math: the bf16 banner, and the messages of the fp32 run."""
    out, err = run_cli(DEVICE, DEMO, "--fast-math")
    out32, _ = run_cli(DEVICE, DEMO)
    r = dict(lines=len(strip_date(out)) - 1, messages=sorted(messages(out)),
             fp32_messages=sorted(messages(out32)),
             banner="Precision: bf16 inputs, f32 accumulation" in err)
    assert r["banner"], err[-2000:]
    assert messages(out) == messages(out32) == DEMO_MESSAGES, r
    return r


def step_mesh(rec: dict) -> None:
    dev = torch.device(DEVICE)
    for n_time, n_freq in MESH_SHAPES:
        for name, cfg, windows in mesh_cases():
            tag = f"({n_time}, {n_freq}) {name}"
            mesh_parity(rec.setdefault(tag, {}), cfg, windows, n_time, n_freq, dev)
            log(f"[mesh] {tag}: {rec[tag]}")


def step_inputs(rec: dict) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        input_paths(rec, torch.device(DEVICE), pathlib.Path(tmp))
    log(f"[inputs] {rec}")


def graph_inputs(windows: np.ndarray, nb: int, rng) -> tuple:
    """Two different (nb, raw_len) batches of the stream's windows on the
    host: the windows in turn from window 2 (on the demo a ping), and from
    window 10 with every fourth window noise."""
    first = np.stack([windows[(i + 2) % len(windows)] for i in range(nb)])
    second = np.stack([windows[(i + 10) % len(windows)] for i in range(nb)])
    noise = rng.normal(0, 1000 if windows.dtype == np.int16 else 20, second[::4].shape)
    second[::4] = np.clip(noise, np.iinfo(windows.dtype).min, np.iinfo(windows.dtype).max)
    return first, second


def graph_parity(cfg, batches, dev) -> tuple:
    """A GraphedPipeline of cfg on dev against the eager DecodePipeline on
    the same pipeline: the capture call on batches[0] (its result is an eager
    pass), then replays on each batch in turn and on batches[0] again: every
    field of every call equal bit for bit to the eager forward's on the same
    input; two consecutive replays' results in distinct buffers; each
    replay's launches (kernels.launch_counts, set to 0 just before) those of
    one eager pass, of the path's kernels. Returns (statistics with the
    graph's pool and the first call's host-clock ms, the GraphedPipeline)."""
    pipe = pipeline.DecodePipeline(cfg).to(dev)
    graphed = graphs.GraphedPipeline(pipe)
    raws = [torch.from_numpy(b).to(dev) for b in batches]
    kernels.reset_launch_counts()
    eager = [pipe(r) for r in raws]
    torch.cuda.synchronize()
    eager_counts = {k: n // len(raws) for k, n in kernels.launch_counts().items()}
    t0 = time.perf_counter()
    got = [graphed.run(raws[0])]  # the first call: an eager pass and the capture
    torch.cuda.synchronize()
    first_call_ms = (time.perf_counter() - t0) * 1e3
    replay_counts = []
    for r in raws + raws[:1]:
        kernels.reset_launch_counts()
        got.append(graphed.run(r))
        replay_counts.append(kernels.launch_counts())
    torch.cuda.synchronize()
    want = [eager[0]] + eager + eager[:1]
    unequal = [(i, f) for i, (g, w) in enumerate(zip(got, want))
               for f, x, y in zip(w._fields, g.unpack(), w) if not torch.equal(x, y)]
    (g_rec,) = graphed.graphs.values()
    rec = dict(calls=len(got), replays=len(got) - 1, unequal=unequal,
               distinct_buffers=len({r.buf.data_ptr() for r in got}) == len(got),
               launches_per_replay=replay_counts[0], eager_launches_per_pass=eager_counts,
               pool_mib=g_rec.pool_bytes / 2 ** 20, first_call_ms=first_call_ms,
               found=int(want[1].found.sum()))
    assert not unequal, rec
    assert rec["distinct_buffers"], rec
    assert all(c == eager_counts for c in replay_counts), (replay_counts, eager_counts)
    assert {k for k, n in eager_counts.items() if n} == path_kernels(cfg), rec
    return rec, graphed


def graph_cases():
    """(name, config, the stream's windows) of the graph step: the demo and
    the busy band, each in float32 and bf16."""
    busy = stimulus.stream_windows(stimulus.busy_band_audio())
    for name, cfg, windows in (("demo", DecoderConfig(), demo_windows()), ("busy", BUSY, busy)):
        for fast in (False, True):
            yield f"{name}{' bf16' if fast else ''}", cfg.replace(fast_math=fast), windows


def allowed_differences(snr: float) -> int:
    """Trials that may decode on one device only: none down to -6 dB, one at
    the noise floor below."""
    return 0 if snr >= -6.0 else 1


def step_sensitivity(rec: dict) -> None:
    cfg = DecoderConfig(**sensitivity_sweep.PROTOCOL)
    snrs, trials = sensitivity_sweep.SNRS, sensitivity_sweep.TRIALS
    results = {}
    for name, dev in (("card", DEVICE), ("cpu", "cpu")):
        t0 = time.perf_counter()
        results[name] = sensitivity_sweep.sweep(cfg, snrs, trials, dev)
        rec[f"{name}_seconds"] = time.perf_counter() - t0
    log(sensitivity_sweep.table(cfg, trials, results))
    rec["protocol"] = dict(sensitivity_sweep.PROTOCOL, trials=trials, message=sensitivity_sweep.MESSAGE,
                           nbadsync_threshold=cfg.nbadsync_threshold,
                           prefilter=pipeline.resolve_prefilter(cfg, cfg.num_candidates))
    diff = {s: sorted(set(results["card"][s]) ^ set(results["cpu"][s])) for s in snrs}
    for name in ("card", "cpu"):
        rec[name] = {f"{s:g}": len(results[name][s]) for s in snrs}
        rec[f"{name}_trials"] = {f"{s:g}": results[name][s] for s in snrs}
    rec["differ"] = {f"{s:g}": diff[s] for s in snrs}
    for s in snrs:
        assert len(diff[s]) <= allowed_differences(s), (s, diff[s])


def step_soak(rec: dict) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "soak.raw"
        path.write_bytes(stimulus.soak_audio(1234).tobytes())
        out, err = run_cli(DEVICE, path, *SOAK_FLAGS)
        out_cpu, _ = run_cli("cpu", path, *SOAK_FLAGS)
    lines = [ln for ln in out.splitlines() if ln.startswith("*** ")]
    texts = [re.search(r"msg='([^']*)'", ln).group(1) for ln in lines]
    f0s = [float(re.search(r"f0=\s*([0-9.]+)", ln).group(1)) for ln in lines]
    rec.update(windows=stimulus.SOAK_WINDOWS, lines=len(lines),
               per_text={t: texts.count(t) for t in sorted(set(texts))},
               equal_to_cpu=strip_date(out) == strip_date(out_cpu))
    log(f"[soak] {rec}")
    assert out.rstrip().endswith("Done"), out[-2000:]
    assert set(texts) == {b[0] for b in stimulus.SOAK_BURSTS}, rec
    for text, f0, *_ in stimulus.SOAK_BURSTS:
        assert 1 <= texts.count(text) <= 8, (text, rec)
        assert all(abs(g - f0) <= 2.0 for g, t in zip(f0s, texts) if t == text), (text, f0s)
    assert "Incomplete read error" in err
    assert rec["equal_to_cpu"], (out, out_cpu)


def path_kernels(cfg) -> set:
    """The kernels a pass of cfg launches, by their launch_counts keys."""
    names = {"scan", "survivor" if cfg.survivor_prefilter != 0 else "demod", "bp"}
    return {f"{k}_fast" for k in names} if cfg.fast_math else names


def fast_demo_pass(rec: dict, cfg, dev) -> dict:
    """A StreamDecoder pass of cfg in fast mode over the demo on the card,
    its launch counts set to 0 just before and read just after: it decodes
    the demo's three messages, launches only its path's fast kernels, and
    its summary equals the CPU's fast plain path. Returns its summary."""
    windows = demo_windows()
    kernels.reset_launch_counts()
    with contextlib.redirect_stderr(io.StringIO()):
        best = decode_best(StreamDecoder(cfg, dev), windows)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    with contextlib.redirect_stderr(io.StringIO()):
        best_cpu = decode_best(StreamDecoder(cfg, "cpu"), windows)
    rec.update(launches=counts, card={m: list(v) for m, v in sorted(best.items())},
               cpu={m: list(v) for m, v in sorted(best_cpu.items())})
    assert set(best) == DEMO_MESSAGES, rec
    assert {k for k, n in counts.items() if n} == path_kernels(cfg), rec
    assert {m: v[:2] for m, v in best.items()} == {m: v[:2] for m, v in best_cpu.items()}, rec
    return best


def step_precision(rec: dict) -> None:
    """The bf16 mode against float32, card against card (see the module
    docstring)."""
    dev = torch.device(DEVICE)
    # the sweep's protocol in both precisions
    cfg = DecoderConfig(**sensitivity_sweep.PROTOCOL)
    snrs, trials = sensitivity_sweep.SNRS, sensitivity_sweep.TRIALS
    results = {}
    for name, c in (("fp32", cfg), ("bf16", cfg.replace(fast_math=True))):
        t0 = time.perf_counter()
        results[name] = sensitivity_sweep.sweep(c, snrs, trials, dev)
        rec[f"sweep_{name}_seconds"] = time.perf_counter() - t0
    log(sensitivity_sweep.table(cfg, trials, results))
    diff = {s: sorted(set(results["fp32"][s]) ^ set(results["bf16"][s])) for s in snrs}
    for name in results:
        rec[f"sweep_{name}"] = {f"{s:g}": results[name][s] for s in snrs}
    rec["sweep_differ"] = {f"{s:g}": diff[s] for s in snrs}
    # the busy band: the prefilter off and K = every candidate, then the
    # prefilter path at K = 256
    windows = stimulus.stream_windows(stimulus.busy_band_audio())
    busy = {}
    for tag, c in (("full_kall", BUSY.replace(survivor_prefilter=0,
                                              max_survivors=BUSY.num_candidates)),
                   ("prefilter_k256", BUSY)):
        for name, cc in (("fp32", c), ("bf16", c.replace(fast_math=True))):
            with contextlib.redirect_stderr(io.StringIO()):
                busy[tag, name] = decode_best(StreamDecoder(cc, dev), windows)
            rec[f"busy_{tag}_{name}"] = {m: list(v) for m, v in sorted(busy[tag, name].items())}
    # the demo in fast mode on both paths, and the deep scan's -4 dB decode
    for tag, c in (("demo_main", DecoderConfig()), ("demo_full", DecoderConfig(survivor_prefilter=0))):
        fast_demo_pass(rec.setdefault(tag, {}), c.replace(fast_math=True), dev)
    weak = stimulus.synthesize_audio_int16([("CQ K1ABC FN42", 1500.0)], 6, snr_db=-4.0,
                                           rng=np.random.default_rng(1000))
    with contextlib.redirect_stderr(io.StringIO()):
        deep = StreamDecoder(DEEP.replace(fast_math=True), dev).decode_block(weak[: C.WINDOW_LEN])
    rec["deep_weak"] = [(r.message, r.num_avg, r.nbadsync, r.f0) for r in deep]
    log(f"[precision] {rec}")
    for s in snrs:
        assert len(diff[s]) <= allowed_differences(s), (s, diff[s])
    per_msg = {k: {m: v[:2] for m, v in b.items()} for k, b in busy.items()}
    assert set(per_msg["full_kall", "fp32"]) == {p[0] for p in stimulus.BUSY_BAND_PINGS}
    assert per_msg["full_kall", "bf16"] == per_msg["full_kall", "fp32"], per_msg
    assert set(busy["prefilter_k256", "bf16"]) == set(busy["prefilter_k256", "fp32"]), busy
    assert {r.message for r in deep} == {"CQ K1ABC FN42"}, rec["deep_weak"]


def step_graph(rec: dict) -> None:
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(11)
    for name, cfg, windows in graph_cases():
        for nb in (1, 64):
            rec[f"{name} B={nb}"], _ = graph_parity(cfg, graph_inputs(windows, nb, rng), dev)
            torch.cuda.empty_cache()
    out, err = run_cli(DEVICE, DEMO, "--fast-math", "--window-batch=8", "--pipeline-depth=4")
    out1, _ = run_cli(DEVICE, DEMO, "--fast-math")
    rec["cli_fast_math_throughput"] = dict(lines=len(strip_date(out)) - 1,
                                           equal_to_window_by_window=strip_date(out) == strip_date(out1))
    for name, r in rec.items():
        log(f"[graph] {name}: {r}")
    assert rec["cli_fast_math_throughput"]["equal_to_window_by_window"], (out, out1)
    assert messages(out) == DEMO_MESSAGES and "Throughput:" in err, (out, err[-2000:])


STEPS = (("gpu_tests", step_gpu_tests), ("kernels", step_kernels), ("busyband", step_busyband),
         ("cli", step_cli), ("mesh", step_mesh), ("inputs", step_inputs),
         ("sensitivity", step_sensitivity), ("soak", step_soak), ("precision", step_precision),
         ("graph", step_graph))


def main() -> int:
    if sys.flags.optimize:  # -O strips the asserts that are the checks
        print("run_hwtests: run it without -O: its checks are asserts", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("run_hwtests: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    report = {"card": card_line(), "device": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(), "torch": torch.__version__,
              "cuda": torch.version.cuda, "nvcc": nvcc_version(), "steps": {}}
    log(f"{report['card']}; torch {report['torch']}, CUDA {report['cuda']}, {report['nvcc']}")
    for name, step in STEPS:
        log(f"== {name}")
        rec: dict = {}
        ts = time.perf_counter()
        try:
            step(rec)
            rec["ok"] = True
        except Exception as e:  # recorded as a failed step; the battery fails
            traceback.print_exc()
            rec["ok"] = False
            rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["seconds"] = time.perf_counter() - ts
        report["steps"][name] = rec
        log(f"== {name}: {'OK' if rec['ok'] else 'FAILED'} ({rec['seconds']:.1f} s)")
    report["seconds"] = time.perf_counter() - t0
    report["provenance"] = provenance()
    report["ok"] = all(r["ok"] for r in report["steps"].values())
    EVIDENCE.write_text(json.dumps(report, indent=1, sort_keys=True) + "\n")
    log(f"{'OK' if report['ok'] else 'FAILED'}: wrote {EVIDENCE.relative_to(ROOT)} "
        f"in {report['seconds']:.1f} s")
    print(json.dumps(report, sort_keys=True), flush=True)
    return 0 if report["ok"] else 2


if __name__ == "__main__":
    sys.exit(main())
