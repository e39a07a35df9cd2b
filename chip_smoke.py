#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Drives msk144cudecoder_tpu_torch (never jax, never the JAX package) through
its main path on the card and fails loudly: every phase asserts, nothing is
caught, and any failure exits non-zero.

  0. environment: a CUDA device is required (exit 1 without one); prints the
     card's name and power limit, the torch, CUDA and nvcc versions; TF32 off
  1. build: compiles csrc/*.cu into the git-ignored _build/ (keyed on a hash
     of the sources); logs ptxas's registers and spills (B2's, B3's and
     B4's per instantiation), and checks in the SASS (cuobjdump) that every
     instance of B1's bf16 kernel runs its correlation, and B2's and B4's
     bf16 instantiations their matched filter, on the tensor cores (HMMA
     instructions)
  2. each kernel against its plain torch version on the card, at main-path
     shapes, with its time by CUDA events (queued: the calls back to back
     behind a device-side sleep; and not queued), the least time
     the card could take for the same work and what bounds it: B1 scan at
     the main path's 64 windows (F=101 depth 4 and F=501 depth 6, dec 4),
     at one window, at 8 windows of each, and at dec 1, with the yardstick
     of one complex64 matmul of the correlation stage alone; B2 survivor
     demod at the main path's 64 windows x 512 rows (default and deep
     configs) and at 16 windows with wrap positions and gap patterns; B3 BP
     on the main path's own rows (the selected survivors of 64 demo
     windows, 16,384 rows) and on 4096 rows of planted codewords and noise;
     B4 full demod (the deep scan's 64 windows, held against the plain
     version 4 windows at a time; F=101 depth 4 on 8 windows, F=501 depth 6
     on 2, depth 8 with 5 candidates per pattern on 2; lags planted at the
     window's wrap points); then the bf16 instantiations (fast_math) against
     the fast plain versions: B1 (on the tensor cores) at every shape of the
     float32 B1's, with its tile, registers, spills and HMMA count; B2 at
     every shape of the float32 B2's, B3 on the fast main path's rows and
     on planted rows, B4 at every shape of the float32 B4's
  3. main path: the CLI on demo/capture.raw on the card decodes the three
     planted messages, with lines identical (but for date=) to --device=cpu;
     an in-process StreamDecoder pass over the demo launches the scan,
     survivor and BP kernels. The same for the full-demod path
     (--survivor-prefilter=0), whose pass launches the scan, demod and BP
     kernels. Then each path's StreamDecoder pass in the bf16 mode
     (DecoderConfig(fast_math=True)): the three messages, and only the fast
     instantiations of the path's kernels launch
  4. busy band: the four-ping pileup at width 200, depth 6, nbadsync 3,
     K=256 decodes all four, with per-message (num_avg, nbadsync) equal to the
     CPU run, and the survivor-overflow warning fires ("at least"); with the
     prefilter off and K=4848 (every candidate) each ping decodes at
     (num_avg, nbadsync) = (1, 0) within one step of its frequency, and at
     K=256 the warning gives the exact count with the same per-message result
  5. deep scan: width 500, step 1, depth 6, nbadsync 3 on the -4 dB stimulus
     decodes
  6. timing with CUDA events: ms/window and x real time at the default and
     deep configs at B=1 and B=64 and of the full-demod path at the deep
     config, the per-stage split, and a torch.profiler trace of a few passes
     (device time per pass, busy share, the largest device entries); the
     bf16 mode beside float32 at B=64 on the default, deep and deep
     full-demod configs, in turns (fp32, bf16, bf16, fp32), with the bf16
     pass's stage split and profile
  7. the throughput CLI on the card: on the demo, --window-batch=8
     --pipeline-depth=4 prints the lines of --window-batch=1 on the card and
     of --device=cpu, with the prefilter on and off; on a long stream (the
     demo tiled to 600 windows) at --window-batch=64, --pipeline-depth=1
     and =4 print the same lines on the default and the deep config, and
     each run's Throughput line is logged; the native framer is in use and
     frames the demo as the numpy framer does; the throughput mode driven in
     this process on the framer's windows prints the CLI's lines and
     launches each path's kernels; --profile-dir writes a trace that names
     a kernel
  8. sharding on the card: MeshDecoder on [cuda:0] x 4 at meshes (1, 4) and
     (2, 2), on the demo and the busy band, with the prefilter on and off:
     its decode summary equals MeshDecoder on the CPU at the same mesh and
     holds the unsharded decode's messages, and the kernels launch on that
     path; its ms/window at (1, 4) beside the unsharded pipeline's; the
     parallel runner in this process at mesh (2, 4) on cuda:0 decodes both
     messages of a two-row capture and launches the kernels; then
     `python -m msk144cudecoder_tpu_torch.parallel` as two gloo processes
     on cuda:0: each prints only its own time row's message, rank 0 ends
     with Done
  9. input paths: IQ input (--read-mode=2, two messages planted around the
     0 Hz centre) and the FFT Hilbert transform (--analytic-method=1, on the
     demo) through the CLI on the card decode the planted messages, with
     lines identical (but for date=) to --device=cpu; each path driven in
     this process through StreamDecoder launches the scan, survivor and BP
     kernels
 10. CUDA graphs (ops/graphs.py, the counterpart of the JAX package's
     jax.jit): for the default, deep, deep full-demod, IQ and
     analytic-method-1 configs, in float32 and bf16, at B = 1 and 64, the
     capture call and two consecutive replays on different inputs equal
     the eager DecodePipeline.forward bit for bit in every field of
     WindowDecodeResult, in distinct buffers, each replay launching one
     eager pass's kernels; each graph's memory pool and the CLI's worst
     case; the CLI with --fast-math on the demo decodes the fp32 run's
     messages

Every StreamDecoder, CLI and MeshDecoder pass on the card above replays
graphs. Phase 6 also times each config and B through the graph against the
eager pipeline in turns (eager, graph, graph, eager), profiles replayed
passes (wall, device ms, busy share; the trace names the path's kernels),
and times the B=1 decode_block latency through the graph against its eager
counterpart in turns.

The checks of phases 2, 3 (the CLI lines), 4, 8 (MeshDecoder parity), 9 and
10 are the on-card battery's (msk144cudecoder_tpu_torch/tools/run_hwtests.py),
called from here so that the two cannot drift; the battery adds the
sensitivity sweep, the streaming soak and the bf16 mode against float32
(its precision step). The line before the last is the JSON kernel table
(each kernel at the main path's shapes, in float32 and, as "<name>_fast",
in bf16; its launches in the phase-3 pass and per pipeline pass, and its
share of the bound, bound_ms / ms); the last line is the JSON device
record.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pathlib
import re
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
# the card's peaks and each kernel's least time: the benchmark's one copy
from bench_torch.common import roofline  # noqa: E402
from bench_torch.common.roofline import (  # noqa: E402
    TAIL_DOT_FLOPS, TAIL_F32_FLOPS, bound, scan_bound, split_ops)
HOP_MS = 216.0  # one 2592-sample hop at 12 kS/s: real time per window
DEVICE = "cuda:0"


def log(msg: str) -> None:
    print(msg, flush=True)


_phase_start = [time.perf_counter()]


def phase_done(n: int) -> None:
    """Log phase n's wall time (host clock, since the previous phase ended)."""
    now = time.perf_counter()
    log(f"[phase {n}] {now - _phase_start[0]:.1f} s")
    _phase_start[0] = now


def cuda_time(fn, reps: int, warmup: int = 2, queued: bool = False) -> float:
    """Mean ms per call of fn() on the current stream, by CUDA events.
    queued: a device-side sleep ahead of the start event keeps the card busy
    while the host enqueues the calls, so that the events time the kernels
    back to back and not the host's launch rate (for a kernel shorter than
    its launch)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(int(2e6 + 2e5 * reps))  # cycles: about 1 ms + 0.1 ms per call
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_times(fn, reps: int) -> tuple[float, float]:
    """A kernel's ms per call queued (the kernel line's `ms`) and not queued
    (each call's launch in the time, the yardstick of earlier readings)."""
    return cuda_time(fn, reps, queued=True), cuda_time(fn, reps)


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bp_bound(llr, valid, res, max_iters: int = 10) -> tuple[int, float, str]:
    """Kernel B3 on these rows: the message updates they need (a row found
    at iteration i ran i updates, a valid row never found max_iters, an
    invalid row none), counted from the tensors, and roofline.bp_bound of
    them."""
    import torch

    updates = int(torch.where(res.found, res.iterations,
                              torch.where(valid, max_iters, 0)).sum().item())
    return (updates, *roofline.bp_bound(updates, llr.shape[0]))


def main() -> int:
    import torch

    # ---- phase 0: environment -------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    if not (ROOT / "msk144cudecoder_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    from msk144cudecoder_tpu_torch import constants as C
    from msk144cudecoder_tpu_torch import stimulus
    from msk144cudecoder_tpu_torch.config import DecoderConfig
    from msk144cudecoder_tpu_torch.ops import demod, graphs, kernels, ldpc, pipeline, scan, survivor
    from msk144cudecoder_tpu_torch.runtime import StreamDecoder
    from msk144cudecoder_tpu_torch.runtime.decoder import to_host
    from msk144cudecoder_tpu_torch.tools import run_hwtests as hw
    from msk144cudecoder_tpu_torch.tools import scan_compare

    card = hw.card_line()
    dev = torch.device(DEVICE)
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    log(hw.nvcc_version())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert "jax" not in sys.modules and "msk144cudecoder_tpu" not in sys.modules

    # ---- phase 1: build ---------------------------------------------------
    t0 = time.perf_counter()
    lib_path = kernels.build()
    kernels.library()
    log(f"[build] {lib_path.name} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {kernels.last_build_seconds})")
    ptxas = lib_path.with_suffix(".log").read_text() if lib_path.with_suffix(".log").exists() else ""
    for ln in ptxas.splitlines():
        if "Used" in ln or "Compiling entry" in ln or "spill" in ln:
            log("[ptxas] " + ln.strip())
    # B1's bf16 instances compute the correlation on the tensor cores, B2's
    # and B4's bf16 instantiations their matched filter
    report = scan_compare.build_report(lib_path, ("scan_fast_kernel", "survivor_kernel",
                                                  "bp_kernel", "demod_kernel"))
    fast_scan = report["scan_fast_kernel"]
    assert fast_scan and all(v[3] > 0 for v in fast_scan.values()), fast_scan
    log("[build] B1 bf16 scan_fast_kernel<dec, tile>: HMMA instructions in the SASS per instance "
        + ", ".join(f"<{k}> {v[3]}" for k, v in fast_scan.items()))
    assert report["survivor_kernel"]["1"][3] > 0, report["survivor_kernel"]
    assert report["demod_kernel"]["1"][3] > 0, report["demod_kernel"]
    for name in ("survivor_kernel", "bp_kernel", "demod_kernel"):
        log(f"[build] {name}<false> / <true>: "
            + "; ".join(f"{regs} registers, spills {st} B stored / {ld} B loaded, {hmma} HMMA"
                        for regs, st, ld, hmma in (report[name][k] for k in ("0", "1"))))

    rng = np.random.default_rng(2026)
    demo = np.frombuffer((ROOT / "demo" / "capture.raw").read_bytes(), dtype=np.int16)
    demo_windows = stimulus.stream_windows(demo)
    kernel_rows = []

    phase_done(1)

    # ---- phase 2: each kernel against its plain version ---------------------
    # the checks are the battery's (tools/run_hwtests.py), at its shapes, in
    # float32 and then in bf16 (the main path's shapes); a kernel row per
    # kernel and mode at the main path's batch
    def row_name(base: str, cfg) -> str:
        return base + ("_fast" if cfg.fast_math else "")

    for cfg, nw in hw.SCAN_CASES + hw.FAST_SCAN_CASES:
        pipe, c = hw.kernel_windows(cfg, nw, rng, dev)
        stats, args = hw.check_scan(pipe, c)
        dec, depth, k = cfg.scan_decimation, cfg.scan_depth, cfg.candidates_per_pattern
        ms, ms_unq = kernel_times(lambda: scan.scan_cuda(*args), reps=20)
        plain_ms = cuda_time(lambda: scan.scan_plain(*args), reps=3)
        bound_ms, bound_by = scan_bound(nw, cfg.num_freqs, depth, k, dec, cfg.fast_math)
        name = hw.scan_name(cfg, nw)
        build = ""
        if cfg.fast_math:
            ft = scan.scan_tile(nw, cfg.num_freqs, dec, kernels.num_sms(dev))
            regs, spill_st, spill_ld, n_hmma = fast_scan[f"{dec},{ft}"]
            build = (f", tile {ft}: {regs} registers, spills {spill_st} B stored / {spill_ld} B "
                     f"loaded, {n_hmma} HMMA")
        log(f"[B1] {name}: pos agree {stats['pos_agree_min']:.4f} (least over the patterns "
            f"but 5 and 6), near ties {stats['near_ties']}, max |dxb| {stats['max_abs_err']:.3g}, "
            f"kernel {ms:.4f} ms ({ms_unq:.4f} not queued), plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}), share {bound_ms / ms:.3f}{build}  ({card})")
        if cfg.replace(fast_math=False) == DecoderConfig() and nw == 64:
            kernel_rows.append(dict(name=row_name("scan", cfg), route="cuda",
                                    source="msk144cudecoder_tpu_torch/csrc/scan.cu",
                                    replaces="msk144cudecoder_tpu/ops/pallas_scan.py:139",
                                    max_abs_err=stats["max_abs_err"],
                                    ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                    bound_by=bound_by, library_ms=None, shape=name))
        if cfg == DecoderConfig() and nw == 64:
            # a yardstick, not the same function: the correlation stage
            # alone as one complex64 matmul of the (64 * 1296, 42) Hankel
            # matrix by B (42, F), TF32 off
            lags = torch.arange(0, C.WINDOW_LEN, dec, device=dev)
            taps = torch.arange(C.SYNC_CORR_LEN, device=dev)
            ext = torch.cat([c, c[:, : C.SYNC_CORR_LEN - 1]], dim=1)
            hank = ext[:, lags[:, None] + taps[None, :]].reshape(-1, C.SYNC_CORR_LEN)
            hank = hank.conj().resolve_conj().contiguous()
            mm_ms = cuda_time(lambda: torch.matmul(hank, pipe.B), reps=20)
            log(f"[B1] yardstick: torch.matmul {tuple(hank.shape)} x {tuple(pipe.B.shape)} "
                f"complex64 (correlation only) {mm_ms:.4f} ms  ({card})")
    torch.cuda.empty_cache()

    # B2: the main path's survivor rows of 64 windows (default and deep
    # configs), and of 16 windows with wrap positions and gap patterns
    # planted in every window
    for cfg, nw, plant in hw.SURVIVOR_CASES + hw.FAST_SURVIVOR_CASES:
        pipe, c = hw.kernel_windows(cfg, nw, rng, dev)
        stats, sargs, (sb_k, nb_k) = hw.check_survivor(pipe, c, plant)
        ms, ms_unq = kernel_times(lambda: survivor.demod_survivors_cuda(*sargs), reps=20)
        plain_ms = cuda_time(lambda: survivor.demod_survivors_plain(*sargs), reps=5)
        pos_f, p_idx, dt = sargs[3], sargs[5], sargs[6]
        # per row the mix and the pattern sum (8 FLOPs a sample and active
        # frame), the carrier (one complex product a sample; in the bf16 mode
        # two, W[f, 128j] W[f, r] and the frame times it) and the tail
        n_frames = pipe.masks.sum(dim=1)[p_idx.long()]
        rows = p_idx.numel()
        mix = float(C.FRAME_LEN * 8 * n_frames.sum().item())
        carrier = C.FRAME_LEN * rows * (12 if cfg.fast_math else 6)
        bound_ms, bound_by = bound(
            **split_ops(cfg.fast_math, f32=TAIL_F32_FLOPS * rows, bf16=mix + carrier,
                        dot=TAIL_DOT_FLOPS * rows),
            nbytes=tensor_bytes(*sargs[:6], *dt, sb_k, nb_k))
        name = hw.survivor_name(cfg, nw, pos_f.shape[1], plant)
        log(f"[B2] {name}: nbadsync unequal {stats['nbadsync_unequal']} (all near 0: "
            f"{stats['unequal_near_zero']}), max rel {stats['max_rel']:.3g}, kernel {ms:.4f} ms "
            f"({ms_unq:.4f} not queued), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}), share {bound_ms / ms:.3f}, rows per block "
            f"{survivor.rows_per_block(pos_f.shape[1], nw, kernels.num_sms(dev))}  ({card})")
        if cfg.replace(fast_math=False) == DecoderConfig() and nw == 64:
            kernel_rows.append(dict(name=row_name("survivor", cfg), route="cuda",
                                    source="msk144cudecoder_tpu_torch/csrc/survivor.cu",
                                    replaces="msk144cudecoder_tpu/ops/pallas_survivor.py:229",
                                    max_abs_err=stats["max_abs_err"],
                                    ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                    bound_by=bound_by, library_ms=None, shape=name))
    torch.cuda.empty_cache()

    # B3: the main path's own rows, the selected survivors of 64 demo
    # windows (16,384 rows); then 4096 rows, half planted codewords + noise,
    # a quarter pure noise, a quarter planted but marked invalid
    for tag, llr, valid, lt, fast in [(*case, fast) for fast in (False, True)
                                      for case in hw.bp_inputs(rng, dev, fast)]:
        stats, r_k = hw.check_bp(tag, llr, valid, lt, fast)
        ms, ms_unq = kernel_times(lambda: ldpc.bp_decode_cuda(llr, valid, lt, fast=fast), reps=20)
        plain_ms = cuda_time(lambda: ldpc.bp_decode_plain(llr, valid, lt, fast=fast), reps=5)
        updates, bound_ms, bound_by = bp_bound(llr, valid, r_k)
        name = hw.bp_name(tag, llr.shape[0], fast)
        log(f"[B3] {name}: outputs unequal to the plain version's: {stats['unequal_outputs']} "
            f"({stats['found']} found, {stats['valid']} valid, {updates} row-iterations of "
            f"updates), kernel {ms:.4f} ms ({ms_unq:.4f} not queued), plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}), share {bound_ms / ms:.3f}  ({card})")
        if tag == "main-path rows":
            kernel_rows.append(dict(name="bp_fast" if fast else "bp", route="cuda",
                                    source="msk144cudecoder_tpu_torch/csrc/bp.cu",
                                    replaces="msk144cudecoder_tpu/ops/pallas_ldpc.py:115",
                                    max_abs_err=stats["max_abs_err"],
                                    ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                    bound_by=bound_by, library_ms=None, shape=name))

    # B4: the full-demod path's grid of every scan candidate, with lags
    # planted at the window's wrap points in every window; the deep scan's
    # batch of 64 windows (1,539,072 rows) is held against the plain version
    # 4 windows at a time (whole, it would hold (64, 501, 6, 5184) complex
    # sums). Rule: softbits within 5e-3 relative (as B2); nbadsync equal on
    # >= 99.99 % of the rows (noise rows' sync softbits can sit at +-0), and
    # every unequal row has a plain sync softbit within 1e-3 of 0 before
    # scaling
    for cfg, nw in hw.DEMOD_CASES + hw.FAST_DEMOD_CASES:
        cfg = cfg.replace(survivor_prefilter=0)
        pipe, c = hw.kernel_windows(cfg, nw, rng, dev)
        stats, dargs, chunks, (sb_k, nb_k) = hw.check_demod(pipe, c)
        ms, ms_unq = kernel_times(lambda: demod.demod_candidates_cuda(*dargs),
                                  reps=5 if nw == 64 else 20)

        def plain_all():
            for a in chunks:
                demod.demod_candidates_plain(*a)

        plain_ms = cuda_time(plain_all, reps=1 if nw == 64 else 3, warmup=1)
        # the benchmark's count of B4's work (bench_torch/common/roofline.py)
        bound_ms, bound_by = roofline.demod_bound(nw, cfg.num_freqs, cfg.scan_depth,
                                                  cfg.candidates_per_pattern, cfg.fast_math)
        name = hw.demod_name(cfg, nw, nb_k.numel())
        log(f"[B4] {name}: max rel {stats['max_rel']:.3g}, nbadsync equal on "
            f"{stats['nbadsync_equal_share']:.6f} of rows ({stats['nbadsync_unequal']} unequal, "
            f"all near 0: {stats['unequal_near_zero']}), kernel {ms:.4f} ms ({ms_unq:.4f} not "
            f"queued), plain {plain_ms:.4f} ms ({len(chunks)} calls of <= 4 windows), bound "
            f"{bound_ms:.4f} ms ({bound_by}), share {bound_ms / ms:.3f}  ({card})")
        if nw == 64:
            kernel_rows.append(dict(name=row_name("demod", cfg), route="cuda",
                                    source="msk144cudecoder_tpu_torch/csrc/demod.cu",
                                    replaces="msk144cudecoder_tpu/ops/pallas_demod.py:169",
                                    max_abs_err=stats["max_abs_err"], ms=ms, plain_ms=plain_ms,
                                    bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                                    shape=name))
        del sb_k, nb_k, dargs, chunks
        torch.cuda.empty_cache()

    phase_done(2)

    # ---- phase 3: main path, then the full-demod path ----------------------
    # each path is driven with the launch counts set to 0 just before it and
    # read just after; a path's kernels must each launch, the other path's not
    paths = (("main", (), DecoderConfig(), ("scan", "survivor", "bp")),
             ("full", ("--survivor-prefilter=0",), DecoderConfig(survivor_prefilter=0),
              ("scan", "demod", "bp")))
    path_counts = {}
    cli_out = {}  # tag -> the card's CLI stdout, for phase 7
    for tag, flags, cfg, path_kernels in paths:
        rec = {}
        cli_out[tag] = hw.demo_cli(rec, *flags)
        log(f"[{tag}] CLI {' '.join(flags)} on the card: {rec['lines']} lines, identical to "
            f"--device=cpu and to --window-batch=8 --pipeline-depth=4 on the card, but for "
            f"date=; messages {rec['messages']}")
        log(f"[{tag}] {rec['warning']}")

        found, counts = stream_pass(StreamDecoder(cfg, dev), demo_windows)
        assert found == hw.DEMO_MESSAGES, (tag, found)
        assert all((n > 0) == (k in path_kernels) for k, n in counts.items()), (tag, counts)
        log(f"[{tag}] StreamDecoder pass over {len(demo_windows)} demo windows: "
            f"launches {counts}")
        path_counts.update({k: counts[k] for k in path_kernels if k not in path_counts})
    for tag, _, cfg, _ in paths:  # the same passes in the bf16 mode
        cfg = cfg.replace(fast_math=True)
        found, counts = stream_pass(StreamDecoder(cfg, dev), demo_windows)
        assert found == hw.DEMO_MESSAGES, (tag, found)
        assert {k for k, n in counts.items() if n} == hw.path_kernels(cfg), (tag, counts)
        log(f"[{tag} bf16] StreamDecoder pass over {len(demo_windows)} demo windows in the "
            f"bf16 mode: messages {sorted(found)}; launches {counts}")
        path_counts.update({k: counts[k] for k in hw.path_kernels(cfg) if k not in path_counts})
    for row in kernel_rows:  # one pipeline pass per demo window
        row["launches"] = path_counts[row["name"]]
        row["launches_per_pass"] = row["launches"] / len(demo_windows)

    phase_done(3)

    # ---- phase 4: busy band -----------------------------------------------
    busy = {}
    hw.busy_band(busy, dev)
    log(f"[busy] four pings decoded, (num_avg, nbadsync) equal to the CPU run: "
        f"{busy['prefilter_k256']}; warning: {busy['prefilter_k256_warning']}")
    k_all = hw.BUSY.num_candidates
    log(f"[busy] prefilter 0, K={k_all}: {busy[f'full_k{k_all}']}; K=256: the same "
        f"(num_avg, nbadsync), warning: {busy['full_k256_warning']}")

    phase_done(4)

    # ---- phase 5: deep scan, weak signal -----------------------------------
    weak = stimulus.synthesize_audio_int16([("CQ K1ABC FN42", 1500.0)], 6, snr_db=-4.0,
                                           rng=np.random.default_rng(1000))
    with contextlib.redirect_stderr(io.StringIO()):
        weak_res = StreamDecoder(hw.DEEP, dev).decode_block(weak[: C.WINDOW_LEN])
    assert {r.message for r in weak_res} == {"CQ K1ABC FN42"}, weak_res
    log(f"[deep] -4 dB stimulus decodes at width 500 step 1 depth 6: "
        f"{[(r.message, r.num_avg, r.nbadsync, r.f0) for r in weak_res]}")

    phase_done(5)

    # ---- phase 6: timing --------------------------------------------------
    for name, cfg in (("default", DecoderConfig()), ("deep", hw.DEEP),
                      ("deep full demod", hw.DEEP.replace(survivor_prefilter=0))):
        pipe = pipeline.DecodePipeline(cfg).to(dev)
        graphed = graphs.GraphedPipeline(pipe)
        for nb in (1, 64):
            raws = np.stack([demo_windows[i % len(demo_windows)] for i in range(nb)])
            raw = torch.from_numpy(raws).to(dev)
            ms = cuda_time(lambda: pipe(raw), reps=10 if nb == 1 else 3)
            stages = stage_split(pipe, raw, reps=9)
            log(f"[time] {name} B={nb}: {ms / nb:.4f} ms/window, "
                f"{HOP_MS * nb / ms:.1f}x real time, {C.HOP_LEN * nb / ms * 1e3:.4g} "
                f"samples/s; stages (median ms/call) "
                + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()) + f"  ({card})")
            passes = 20 if nb == 1 else 5
            wall, busy, n_ops, top, _ = profile_passes(pipe, raw, passes)
            log(f"[profile] {name} B={nb}: wall {wall:.4f} ms/pass, device {busy:.4f} ms/pass "
                f"({n_ops:.0f} device ops/pass), busy share {busy / wall:.4f}; largest: "
                + ", ".join(f"{k} {v:.4f}" for k, v in top) + f"  ({card})")
            # the same passes through the graph: in turns against eager, then
            # profiled; the replayed trace names the path's kernels
            graphed(raw)  # the capture
            turns = {"eager": [], "graph": []}
            for kind in ("eager", "graph", "graph", "eager"):
                fn = pipe if kind == "eager" else graphed
                turns[kind].append(cuda_time(lambda: fn(raw), reps=10 if nb == 1 else 3) / nb)
            wall, busy, n_ops, top, names = profile_passes(graphed, raw, passes)
            want = {"scan_kernel", "bp_kernel",
                    "demod_kernel" if graphed.pipe.pre == 0 else "survivor_kernel"}
            assert want <= names, (name, nb, names)
            (g_rec,) = [g for k, g in graphed.graphs.items() if k[0][0] == nb]
            log(f"[graph] {name} B={nb} in turns eager, graph, graph, eager: ms/window eager "
                + ", ".join(f"{t:.4f}" for t in turns["eager"]) + "; graph "
                + ", ".join(f"{t:.4f}" for t in turns["graph"]) + f"; replayed: wall "
                f"{wall:.4f} ms/pass, device {busy:.4f} ms/pass ({n_ops:.0f} device ops/pass), "
                f"busy share {busy / wall:.4f}; kernels in the trace {sorted(names)}; pool "
                f"{g_rec.pool_bytes / 2 ** 20:.1f} MiB; largest: "
                + ", ".join(f"{k} {v:.4f}" for k, v in top) + f"  ({card})")
        del pipe, graphed
        torch.cuda.empty_cache()
    # the bf16 mode beside float32 at B=64, in turns (fp32, bf16, bf16, fp32)
    raws = np.stack([demo_windows[i % len(demo_windows)] for i in range(64)])
    raw = torch.from_numpy(raws).to(dev)
    for name, cfg in (("default", DecoderConfig()), ("deep", hw.DEEP),
                      ("deep full demod", hw.DEEP.replace(survivor_prefilter=0))):
        pipes = {fast: pipeline.DecodePipeline(cfg.replace(fast_math=fast)).to(dev)
                 for fast in (False, True)}
        turns = {False: [], True: []}
        for fast in (False, True, True, False):
            turns[fast].append(cuda_time(lambda: pipes[fast](raw), reps=5) / 64)
        stages = stage_split(pipes[True], raw, reps=9)
        log(f"[time bf16] {name} B=64 in turns fp32, bf16, bf16, fp32: ms/window fp32 "
            + ", ".join(f"{t:.4f}" for t in turns[False]) + "; bf16 "
            + ", ".join(f"{t:.4f}" for t in turns[True]) + "; bf16 stages (median ms/call) "
            + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()) + f"  ({card})")
        wall, busy, n_ops, top, _ = profile_passes(pipes[True], raw, passes=5)
        log(f"[profile bf16] {name} B=64: wall {wall:.4f} ms/pass, device {busy:.4f} ms/pass "
            f"({n_ops:.0f} device ops/pass), busy share {busy / wall:.4f}; largest: "
            + ", ".join(f"{k} {v:.4f}" for k, v in top) + f"  ({card})")
    # the B=1 decode_block latency through the graph, in turns against its
    # eager counterpart (the same steps with the eager pipeline's pass)
    dec1 = StreamDecoder(DecoderConfig(), dev)

    def eager_block(w):
        raw1 = torch.from_numpy(np.ascontiguousarray(w[None, :])).to(dev)
        return dec1._postprocess_one(to_host(dec1.pipeline(raw1)), 0)

    with contextlib.redirect_stderr(io.StringIO()):
        for w in demo_windows[:3]:
            dec1.decode_block(w)
            eager_block(w)
        for kind in ("eager", "graph", "graph", "eager"):
            block = eager_block if kind == "eager" else dec1.decode_block
            lats = []
            for w in demo_windows:
                t0 = time.perf_counter()
                block(w)
                lats.append((time.perf_counter() - t0) * 1e3)
            log(f"[time] default B=1 decode_block latency, {kind} (host clock, incl. unpack), "
                f"{len(lats)} windows: median {np.median(lats):.3f} ms, max {max(lats):.3f} ms, "
                f"of the {C.LOOP_SOFT_BUDGET_MS:g} ms loop budget  ({card})")

    phase_done(6)
    phase7_throughput_cli(paths, cli_out, demo, demo_windows, card)
    phase_done(7)
    phase8_sharding(demo_windows, card)
    phase_done(8)
    phase9_inputs()
    phase_done(9)
    phase10_graphs(demo_windows, card)
    phase_done(10)

    print(json.dumps({"kernels": [{**{k: r[k] for k in (
        "name", "route", "source", "replaces", "launches", "launches_per_pass", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
        "share": r["bound_ms"] / r["ms"]} for r in kernel_rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(dev),
                                             "count": torch.cuda.device_count()}}))
    return 0


DEEP_FLAGS = ("--search-width=500", "--search-step=1", "--scan-depth=6",
              "--nbadsync-threshold=3")
KERNEL_NAMES = ("scan_kernel", "survivor_kernel", "demod_kernel", "bp_kernel")


def stream_pass(decoder, windows) -> tuple[set, dict]:
    """The decoder over the windows one by one (submit, collect), with the
    launch counts set to 0 just before: (the messages decoded, the counts
    just after)."""
    import torch

    from msk144cudecoder_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    found = set()
    with contextlib.redirect_stderr(io.StringIO()):
        for w in windows:
            decoder.submit(w)
            for item in decoder.collect():
                found.add(item.message)
    torch.cuda.synchronize()
    return found, kernels.launch_counts()


def phase7_throughput_cli(paths, cli_out, demo, demo_windows, card) -> None:
    """The pipelined throughput mode, the native framer and --profile-dir
    (the demo's pipelined CLI lines are phase 3's)."""
    import torch

    from msk144cudecoder_tpu_torch import cli
    from msk144cudecoder_tpu_torch import constants as C
    from msk144cudecoder_tpu_torch.config import DecoderConfig
    from msk144cudecoder_tpu_torch.ops import kernels
    from msk144cudecoder_tpu_torch.runtime import StreamDecoder, native
    from msk144cudecoder_tpu_torch.runtime.stream import window_stream
    from msk144cudecoder_tpu_torch.tools import run_hwtests as hw

    demo_path = ROOT / "demo" / "capture.raw"
    assert native.available()
    with contextlib.redirect_stderr(io.StringIO()):
        nat = list(native.native_window_stream(io.BytesIO(demo.tobytes()), 1, chunk_bytes=4099))
        ref = list(window_stream(io.BytesIO(demo.tobytes()), 1))
    assert len(nat) == len(ref) == len(demo_windows)
    assert all(np.array_equal(a, b) for a, b in zip(nat, ref))
    log(f"[native] framer {native.library_path().name} in use: {len(nat)} demo windows "
        "equal to the numpy framer's")

    # the throughput mode in this process, so that its launches are counted:
    # the native framer's windows through cli.decode_throughput, each path
    # driven with the counts set to 0 just before it and read just after
    for tag, flags, cfg, path_kernels in paths:
        decoder = StreamDecoder(cfg, DEVICE)
        out = io.StringIO()
        kernels.reset_launch_counts()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
            cli.decode_throughput(decoder, nat, 8, 4)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert all((n > 0) == (k in path_kernels) for k, n in counts.items()), (tag, counts)
        assert hw.strip_date(out.getvalue()) == hw.strip_date(cli_out[tag])[:-1], tag
        log(f"[cli {tag}] decode_throughput in process, B=8 depth 4: the CLI's lines; "
            f"launches {counts}")

    with tempfile.TemporaryDirectory() as tmp:
        n_win = 600  # 130 s of audio
        long = np.tile(demo, -(-(n_win + 1) * C.HOP_LEN // len(demo)))[: (n_win + 1) * C.HOP_LEN]
        long_path = pathlib.Path(tmp) / "long.raw"
        long_path.write_bytes(long.tobytes())
        long_windows = np.stack([long[i * C.HOP_LEN:i * C.HOP_LEN + C.WINDOW_LEN]
                                 for i in range(n_win)])
        for name, flags, cfg in (("default", (), DecoderConfig()), ("deep", DEEP_FLAGS, hw.DEEP)):
            outs = []
            for depth in (1, 4, 4, 1):  # in turns
                t0 = time.perf_counter()
                out, err = hw.run_cli(DEVICE, long_path, "--window-batch=64",
                                      f"--pipeline-depth={depth}", *flags)
                wall = time.perf_counter() - t0
                outs.append(hw.strip_date(out))
                thr = [ln for ln in err.splitlines() if ln.startswith("Throughput:")]
                assert len(thr) == 1, err[-2000:]
                log(f"[throughput] {name} B=64 depth {depth}, {n_win} windows: {thr[0]}; "
                    f"whole process {wall:.2f} s  ({card})")
            assert all(o == outs[0] for o in outs), name
            msgs = {ln.split("msg='")[1].split("'")[0] for ln in outs[0] if "msg='" in ln}
            assert msgs == hw.DEMO_MESSAGES, (name, msgs)
            log(f"[throughput] {name}: depth 1 and 4 print the same {len(outs[0]) - 1} lines")
            # the CLI's per-batch host work in one thread, split: the device
            # call with its fetch (decode_to_host), then unpack and dedup
            dec = StreamDecoder(cfg, DEVICE)
            batches = [long_windows[i:i + 64] for i in range(0, n_win - 63, 64)]
            with contextlib.redirect_stderr(io.StringIO()):
                dec.postprocess_batch(dec.decode_to_host(batches[0]), 64)
                t_call = t_post = 0.0
                for b in batches:
                    t0 = time.perf_counter()
                    res = dec.decode_to_host(b)
                    t1 = time.perf_counter()
                    dec.postprocess_batch(res, 64)
                    t_call += t1 - t0
                    t_post += time.perf_counter() - t1
            n = 64 * len(batches)
            log(f"[throughput] {name} B=64 in one thread, {n} windows (host clock): "
                f"decode_to_host {t_call / n * 1e3:.4f} ms/window, postprocess_batch "
                f"{t_post / n * 1e3:.4f} ms/window  ({card})")

        prof = pathlib.Path(tmp) / "prof"
        _, err = hw.run_cli(DEVICE, demo_path, "--window-batch=8", "--pipeline-depth=4",
                            f"--profile-dir={prof}")
        assert f"Profiler trace written to {prof}" in err, err[-2000:]
        trace = (prof / "trace.json").read_text()
        named = [k for k in KERNEL_NAMES if k in trace]
        assert named, "the trace names none of the four kernels"
        log(f"[profile] {len(trace)} bytes of trace; kernels named: {named}")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase8_sharding(demo_windows, card) -> None:
    """MeshDecoder on one card against its CPU run, and the two-process
    parallel runner on cuda:0."""
    import torch

    from msk144cudecoder_tpu_torch import constants as C
    from msk144cudecoder_tpu_torch import stimulus
    from msk144cudecoder_tpu_torch.config import DecoderConfig
    from msk144cudecoder_tpu_torch.ops import graphs, kernels, pipeline
    from msk144cudecoder_tpu_torch.parallel import MeshDecoder, make_mesh
    from msk144cudecoder_tpu_torch.parallel import cli as parallel_cli
    from msk144cudecoder_tpu_torch.runtime.decoder import to_host
    from msk144cudecoder_tpu_torch.tools import run_hwtests as hw

    dev = torch.device(DEVICE)
    for n_time, n_freq in hw.MESH_SHAPES:
        for name, cfg, windows in hw.mesh_cases():
            rec = {}
            hw.mesh_parity(rec, cfg, windows, n_time, n_freq, dev)
            log(f"[mesh] ({n_time}, {n_freq}) on {DEVICE} x {n_time * n_freq}, {name}: equal "
                f"to the CPU mesh, {rec['messages']} holds the unsharded {rec['unsharded']}; "
                f"launches {rec['launches']}")

    # ms/window at B=64: MeshDecoder (1, 4) on one card against the unsharded
    # pipeline, both with the fetch to the host (host clock)
    raw = np.stack([demo_windows[i % len(demo_windows)] for i in range(64)])
    md = MeshDecoder(DecoderConfig(), make_mesh(1, 4, [dev] * 4))
    graphed = graphs.GraphedPipeline(pipeline.DecodePipeline(DecoderConfig()).to(dev))
    raw_dev = torch.from_numpy(raw)

    def host_ms(fn, reps=5):
        for _ in range(2):
            fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps

    for _ in range(2):  # in turns: unsharded, mesh, mesh, unsharded
        ms_one = host_ms(lambda: to_host(graphed.run(raw_dev.to(dev))))
        ms_mesh = host_ms(lambda: md.decode(raw))
        log(f"[mesh time] default B=64, with the fetch, graphs: unsharded {ms_one / 64:.4f} ms/window, "
            f"MeshDecoder (1, 4) on one card {ms_mesh / 64:.4f} ms/window  ({card})")

    # two processes on one card, joined by gloo
    rng = np.random.default_rng(5)
    a1 = stimulus.synthesize_audio_int16([("CQ K1ABC FN42", 1500.0)], 6, snr_db=10.0, rng=rng)
    a2 = stimulus.synthesize_audio_int16([("K1ABC W9XYZ R-03", 1480.0)], 6, snr_db=10.0, rng=rng)
    noise = rng.normal(0, 1000, C.HOP_LEN * 2).astype(np.int16)
    with tempfile.TemporaryDirectory() as tmp:
        cap = pathlib.Path(tmp) / "capture.raw"
        cap.write_bytes(np.concatenate([a1, noise, a2]).tobytes())
        # the runner in this process, so that its launches are counted: a
        # (2, 4) mesh on cuda:0 decodes both messages
        out = io.StringIO()
        kernels.reset_launch_counts()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
            rc = parallel_cli.main([f"--device={DEVICE}", "--input", str(cap),
                                    "--search-width=100", "--scan-depth=3",
                                    "--mesh-time=2", "--mesh-freq=4"])
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert rc == 0 and out.getvalue().strip().endswith("Done"), (rc, out.getvalue())
        # F = 51 pads to 52: 13 channels x 3 patterns x 8 = 312 candidates
        # per shard, under the auto prefilter's 512 rows, so every shard
        # resolves its prefilter to 0 and runs the full demod
        assert all(counts[k] > 0 for k in ("scan", "demod", "bp")), counts
        assert counts["survivor"] == 0, counts
        assert "msg='CQ K1ABC FN42'" in out.getvalue(), out.getvalue()
        assert "msg='K1ABC W9XYZ R-03'" in out.getvalue(), out.getvalue()
        log(f"[parallel] one process, mesh (2, 4) on {DEVICE}: both messages, "
            f"launches {counts}")
        port = free_port()
        env = dict(os.environ, OMP_NUM_THREADS="2")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "msk144cudecoder_tpu_torch.parallel", f"--device={DEVICE}",
             "--input", str(cap), "--search-width=100", "--scan-depth=3", "--mesh-freq=4",
             "--coordinator", f"127.0.0.1:{port}", "--num-processes=2", f"--process-id={pid}"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)
            for pid in range(2)]
        try:
            outs = [p.communicate(timeout=300) for p in procs]
        finally:
            for p in procs:
                p.kill()
    for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (pid, err[-3000:])
    assert "msg='CQ K1ABC FN42'" in outs[0][0] and "R-03" not in outs[0][0], outs[0][0]
    assert "msg='K1ABC W9XYZ R-03'" in outs[1][0] and "FN42" not in outs[1][0], outs[1][0]
    assert outs[0][0].strip().endswith("Done") and "Done" not in outs[1][0]
    mesh_line = [ln for ln in outs[0][1].splitlines() if ln.startswith("Mesh:")]
    log(f"[parallel] two gloo processes on {DEVICE}: rank 0 printed only row 0's message "
        f"and Done, rank 1 only row 1's; {mesh_line[0]}")


def phase9_inputs() -> None:
    """IQ input and the FFT Hilbert transform on the card against
    --device=cpu, and in process with their launches counted."""
    import torch

    from msk144cudecoder_tpu_torch.tools import run_hwtests as hw

    rec = {}
    with tempfile.TemporaryDirectory() as tmp:
        hw.input_paths(rec, torch.device(DEVICE), pathlib.Path(tmp))
    for tag, r in rec.items():
        log(f"[inputs] {tag}: CLI on the card {r['lines']} lines, identical to --device=cpu "
            f"but for date=; messages {r['messages']}; StreamDecoder in process "
            f"{r['in_process']}, launches {r['launches']}")


def phase10_graphs(demo_windows, card) -> None:
    """The graphs against the eager pipeline, bit for bit, per config,
    precision and B (the battery's graph_parity); the pools; --fast-math."""
    import torch

    from msk144cudecoder_tpu_torch.config import DecoderConfig
    from msk144cudecoder_tpu_torch.parallel.sharding import stream_to_windows
    from msk144cudecoder_tpu_torch.tools import run_hwtests as hw

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(17)
    iq_windows = stream_to_windows(hw.iq_stimulus(), 2)
    cases = (("default", DecoderConfig(), demo_windows), ("deep", hw.DEEP, demo_windows),
             ("deep full demod", hw.DEEP.replace(survivor_prefilter=0), demo_windows),
             ("iq", DecoderConfig.create(read_mode=2), iq_windows),
             ("analytic_method=1", DecoderConfig(analytic_method=1), demo_windows))
    pools = {}
    for name, cfg, windows in cases:
        for fast in (False, True):
            for nb in (1, 64):
                rec, _ = hw.graph_parity(cfg.replace(fast_math=fast),
                                         hw.graph_inputs(windows, nb, rng), dev)
                tag = f"{name}{' bf16' if fast else ''} B={nb}"
                pools[tag] = rec["pool_mib"]
                log(f"[graphs] {tag}: capture call and {rec['replays']} replays equal to the "
                    f"eager forward bit for bit in every field, distinct buffers "
                    f"{rec['distinct_buffers']}, {rec['found']} rows found; launches per replay "
                    f"{ {k: n for k, n in rec['launches_per_replay'].items() if n} } = one eager "
                    f"pass's; pool {rec['pool_mib']:.1f} MiB; first call (an eager pass and the "
                    f"capture) {rec['first_call_ms']:.1f} ms  ({card})")
                torch.cuda.empty_cache()
    worst = max(pools, key=pools.get)
    log(f"[graphs] largest pool: {worst} {pools[worst]:.1f} MiB; the CLI at --pipeline-depth=4 "
        f"holds one graph per worker: {4 * pools[worst] / 1024:.2f} GiB for that config")
    rec = hw.fast_math_cli()
    log(f"[graphs] CLI --fast-math on the demo: {rec['lines']} lines, messages {rec['messages']} "
        f"= the fp32 run's {rec['fp32_messages']}; bf16 banner {rec['banner']}")


def profile_passes(pipe, raw, passes: int):
    """(wall ms per pass by the host clock without the profiler, device ms
    per pass summed over the CUDA entries of a torch.profiler trace, device
    ops per pass, the four largest entries as (name, ms per pass), the
    KERNEL_NAMES the trace names)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        for _ in range(passes):
            pipe(raw)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    wall = (time.perf_counter() - t0) * 1e3 / passes
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    entries = [(e.key, e.device_time_total / 1e3 / passes, e.count / passes)
               for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    entries.sort(key=lambda e: -e[1])
    top = [(re.sub(r"\(.*", "", k.replace("(anonymous namespace)::", "")
                   .replace("void ", ""))[:48], v) for k, v, _ in entries[:4]]
    names = {k for k in KERNEL_NAMES if any(k in e[0] for e in entries)}
    return wall, sum(e[1] for e in entries), sum(e[2] for e in entries), top, names


def stage_split(pipe, raw, reps: int) -> dict:
    """Median ms of each pipeline stage over `reps` full passes (after one
    warm-up pass), by CUDA events around each stage."""
    import torch

    names = ("preprocess", "scan", "prefilter", "demod", "select", "bp", "finish")
    times = {n: [] for n in names}
    for rep in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        ev[0].record()
        c = pipe.preprocess(raw)
        ev[1].record()
        pos, xb = pipe.scan(c)
        ev[2].record()
        front = pipe.prefilter(pos, xb)
        ev[3].record()
        sb_f, nbad_f = pipe.demod(c, front)
        ev[4].record()
        prep = pipe.select(sb_f, nbad_f, front)
        ev[5].record()
        bp = pipe.bp(prep)
        ev[6].record()
        pipe.finish(prep, bp, c)
        ev[7].record()
        ev[7].synchronize()
        if rep:
            for i, n in enumerate(names):
                times[n].append(ev[i].elapsed_time(ev[i + 1]))
    return {n: float(np.median(v)) for n, v in times.items()}


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
