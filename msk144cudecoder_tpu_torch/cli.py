"""Command-line interface: stdin samples in, decoded message lines out.

The flags, defaults, banner and output line of the JAX package's CLI
(msk144cudecoder_tpu/cli.py), which mirror the reference decoder, and its
two modes: window by window with the next window's device work enqueued
before the previous one is post-processed, and the throughput mode
(`--window-batch > 1`), where up to `--pipeline-depth` batches decode at
once on a worker pool (each on its own CUDA stream on a card) while
post-processing stays in stream order. The native C++ framer reads stdin
when it can be built, the numpy one otherwise. On a card both modes replay
a CUDA graph of the pipeline per pass (runtime.StreamDecoder; the throughput
mode's tail batch is padded to the full batch, so one graph per worker
serves the whole run). The port differs in two ways: `--device` (default
cuda) replaces `--platform`, and the CLI decodes in float32 by default
(`Precision: fp32`, the JAX package's `--exact-math`, still accepted);
`--fast-math` selects the bf16 mode (bf16 inputs, float32 accumulation: the
kernels' bf16 instantiations, DecoderConfig(fast_math=True)), the JAX CLI's
default. The banner names the mode. `--profile-dir` writes a torch.profiler
trace.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from typing import List, Optional

from . import constants as C
from .config import DecoderConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="msk144torchdecoder",
        description=(
            "MSK144 stream decoder (PyTorch, CUDA kernels). Reads 12 kS/s "
            "samples on stdin (16-bit signed mono audio, or 2x8-bit signed "
            "IQ), prints decoded messages on stdout."
        ),
    )
    p.add_argument("--center-frequency", type=float, default=None,
                   help="center frequency in Hz (default: 1500 audio, 0 IQ)")
    p.add_argument("--search-step", type=float, default=2.0,
                   help="frequency search step in Hz (default 2.0)")
    p.add_argument("--search-width", type=float, default=200.0,
                   help="frequency search width in Hz (default 200)")
    p.add_argument("--scan-depth", type=int, default=4,
                   help="frame-averaging depth 1..8 (default 4)")
    p.add_argument("--read-mode", type=int, default=1, choices=(1, 2),
                   help="1 = 16-bit audio, 2 = 2x8-bit IQ (default 1)")
    p.add_argument("--analytic-method", type=int, default=2, choices=(1, 2),
                   help="1 = FFT Hilbert, 2 = shift+FIR+shift (default 2)")
    p.add_argument("--nbadsync-threshold", type=int, default=1,
                   help="max bad sync bits per candidate (default 1)")
    p.add_argument("--max-survivors", type=int, default=256,
                   help="static LDPC batch size (top-K survivors under "
                        "per-pattern quotas); the survivor-overflow warning "
                        "on stderr is the signal to raise it (default 256)")
    p.add_argument("--scan-decimation", type=int, default=4, choices=(1, 2, 4),
                   help="coarse sync-scan lag grid: correlate every Nth lag; "
                        "1 = the full per-lag grid of the reference (default 4)")
    p.add_argument("--candidates-per-pattern", type=int, default=8,
                   help="top-k candidate lags demodulated per (frequency, "
                        "pattern), 1..8 (default 8 = reference behavior)")
    p.add_argument("--survivor-prefilter", type=int, default=None,
                   help="demodulate only the top-P candidates by scan sync "
                        "correlation (default: auto = 2x max-survivors; 0 = "
                        "off: demodulate every candidate, with an exact "
                        "survivor count)")
    p.add_argument("--window-batch", type=int, default=1,
                   help="windows decoded per device call")
    p.add_argument("--pipeline-depth", type=int, default=4,
                   help="batches in flight in throughput mode (window-batch "
                        "> 1): device calls for up to this many batches run "
                        "concurrently, each on its own CUDA stream, while "
                        "post-processing stays in stream order; 1 = fully "
                        "synchronous (default 4)")
    precision = p.add_mutually_exclusive_group()
    precision.add_argument("--fast-math", action="store_true",
                           help="decode in the bf16 mode: bf16 inputs, f32 "
                                "accumulation (the kernels' bf16 "
                                "instantiations); the default is fp32")
    precision.add_argument("--exact-math", action="store_true",
                           help="compute in fp32: the JAX CLI's exact mode and "
                                "the port's CLI default, so accepted for "
                                "compatibility")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to decode on: cuda (default), cuda:N "
                        "or cpu (the kernels' plain torch versions)")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace (host ops and, "
                        "on a card, CUDA kernels) of the decode loop to this "
                        "directory")
    return p


def config_from_args(args: argparse.Namespace) -> DecoderConfig:
    kwargs = dict(
        search_step=args.search_step,
        search_width=args.search_width,
        scan_depth=args.scan_depth,
        read_mode=args.read_mode,
        analytic_method=args.analytic_method,
        nbadsync_threshold=args.nbadsync_threshold,
        max_survivors=args.max_survivors,
        candidates_per_pattern=args.candidates_per_pattern,
        survivor_prefilter=args.survivor_prefilter,
        window_batch=args.window_batch,
        fast_math=args.fast_math,
        scan_decimation=args.scan_decimation,
    )
    if args.center_frequency is not None:
        kwargs["center_frequency"] = args.center_frequency
    return DecoderConfig.create(**kwargs)


def print_banner(cfg: DecoderConfig, device, out=None) -> None:
    """Actual-parameters banner (the reference's, plus the port's lines)."""
    out = out if out is not None else sys.stderr
    mode = "16-bit signed real" if cfg.read_mode == 1 else "2x8-bit signed IQ"
    lines = [
        "Actual parameters:",
        f"Center Frequency: {cfg.center_frequency:g}Hz",
        f"Search Step: {cfg.search_step:g}Hz",
        f"Search Width: {cfg.search_width:g}Hz",
        f"Scan Depth: {cfg.scan_depth}",
        f"Left Boundary: {cfg.left_bound:g}Hz",
        f"Right Boundary: {cfg.right_bound:g}Hz",
        f"Read Mode: ({mode})",
    ]
    if cfg.read_mode == 1:
        lines.append(f"Analytic Method: {cfg.analytic_method}")
    lines += [
        f"Badsync Threshold: {cfg.nbadsync_threshold}",
        f"Frequency channels: {cfg.num_freqs}",
        f"Candidate slots: {cfg.num_candidates}",
        f"LDPC survivor batch: {cfg.max_survivors}",
        f"Scan lag grid: every {cfg.scan_decimation} sample(s)",
        f"Precision: {'bf16 inputs, f32 accumulation' if cfg.fast_math else 'fp32'}",
        f"Device: {device}",
        "",
    ]
    print("\n".join(lines), file=out)


def resolve_device(name: str):
    """The torch device to decode on. A CUDA device that is not there is an
    error, never a silent switch to the CPU."""
    from .ops import kernels

    try:
        return kernels.resolve_device(name)
    except RuntimeError:
        raise SystemExit(
            f"error: --device={name} but no CUDA device is available "
            "(pass --device=cpu to run the plain torch path on the CPU)") from None
    except ValueError:
        raise SystemExit(f"error: unsupported --device={name}: use cuda or cpu") from None


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    device = resolve_device(args.device)
    print_banner(cfg, device)

    from .runtime import StreamDecoder, native
    from .runtime.stream import window_stream

    decoder = StreamDecoder(cfg, device)
    stdin = sys.stdin.buffer
    # the native C++ framer, built on first use; the numpy one without g++
    if native.available():
        windows = native.native_window_stream(stdin, cfg.read_mode)
    else:
        windows = window_stream(stdin, cfg.read_mode)

    with (profile_to(args.profile_dir, device) if args.profile_dir
          else contextlib.nullcontext()):
        if cfg.window_batch <= 1:
            decode_windowed(decoder, windows)
        else:
            decode_throughput(decoder, windows, cfg.window_batch, args.pipeline_depth)
    if args.profile_dir:
        print(f"Profiler trace written to {args.profile_dir}", file=sys.stderr)

    print("Done")
    return 0


def emit(results, ms: float, n_windows: int) -> None:
    """Print a window's decode lines; warn when the loop took longer than
    its budget for n_windows windows."""
    budget = C.LOOP_SOFT_BUDGET_MS * n_windows
    if ms > budget:
        print(
            f"Warning: Working loop takes too much time: {ms:.0f} ms"
            f" of {budget:.0f} ms max.",
            file=sys.stderr,
        )
    for item in results:
        print(item.format_line(), flush=True)


def decode_windowed(decoder, windows) -> None:
    """Window by window, depth-1 pipelined: the next window's device work is
    enqueued before the previous one's results are fetched and
    post-processed. ScopedMetric spans as in the JAX CLI
    (MSK144_TPU_METRICS=1)."""
    from .runtime import metrics
    from .runtime.metrics import ScopedMetric, SimpleTimer

    metrics.refresh()
    timer = SimpleTimer()
    win_iter = iter(windows)
    while True:
        loop_span = ScopedMetric("working_loop")
        with ScopedMetric("ingest"):
            window = next(win_iter, None)
        if window is None:
            loop_span.stop()
            break
        with ScopedMetric("submit"):
            decoder.submit(window)
        if decoder.in_flight > 1:
            with ScopedMetric("collect"):
                results = decoder.collect()
            emit(results, timer.milliseconds_elapsed(), 1)
            timer = SimpleTimer()
        loop_span.stop()
    while decoder.in_flight:
        with ScopedMetric("collect"):
            results = decoder.collect()
        emit(results, timer.milliseconds_elapsed(), 1)
        timer = SimpleTimer()


def decode_throughput(decoder, windows, window_batch: int, pipeline_depth: int) -> None:
    """Throughput mode: window_batch windows per device call, with up to
    pipeline_depth batches' device calls (decode_to_host) in flight on a
    worker pool, while post-processing and output stay in stream order on
    this thread. The stream tail is zero-padded and its pad results
    dropped. Prints the steady-state Throughput line (after the first
    batch, which carries the kernels' first-use cost) on stderr. Spans of
    batch n carry request id n: its windows' `frame` spans, `frame_batch`
    (this thread padding and stacking it), the worker's `decode_to_host`,
    and `drain` (this thread's wait for it and its post-processing)."""
    import itertools
    import time
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from .runtime import metrics
    from .runtime.metrics import ScopedMetric

    metrics.refresh()
    depth = max(1, pipeline_depth)
    pending: deque = deque()  # (future, n_valid, batch id) FIFO
    n_done = 0  # windows post-processed after the first batch
    t_steady = None  # wall clock at the first batch's completion
    last_done = None  # wall clock at the previous batch's completion

    def drain_one():
        nonlocal n_done, t_steady, last_done
        fut, n, seq = pending.popleft()
        with metrics.request(seq), ScopedMetric("drain"):
            with ScopedMetric("device_wait_transfer"):
                res = fut.result()
            now = time.perf_counter()
            ms = 0.0 if last_done is None else (now - last_done) * 1e3
            last_done = now
            if t_steady is None:
                t_steady = now
            else:
                n_done += n
            with ScopedMetric("postprocess"):
                for results in decoder.postprocess_batch(res, n):
                    emit(results, 0.0, 1)
            emit([], ms, n)

    def decode(batch_np: np.ndarray, seq: int):
        with metrics.request(seq):
            return decoder.decode_to_host(batch_np)

    def submit(batch_np: np.ndarray, n_valid: int, seq: int):
        # gate on batches still computing, not on batches awaiting
        # post-processing: waiting for the oldest would idle every worker
        # behind one slow batch. Finished results wait in the deque
        # (bounded by 4 * depth) for their turn in stream order.
        while (sum(not f.done() for f, _, _ in pending) >= depth
               or len(pending) >= 4 * depth):
            drain_one()
        pending.append((pool.submit(decode, batch_np, seq), n_valid, seq))
        while pending and pending[0][0].done():
            drain_one()

    with ThreadPoolExecutor(max_workers=depth) as pool:
        it = iter(windows)
        for seq in itertools.count():
            with metrics.request(seq):
                batch = list(itertools.islice(it, window_batch))
                n = len(batch)
                if not n:
                    break
                with ScopedMetric("frame_batch"):
                    pad = [np.zeros_like(batch[0])] * (window_batch - n)
                    batch_np = np.stack(batch + pad)
            submit(batch_np, n, seq)
            if n < window_batch:
                break
        while pending:
            drain_one()
    if n_done and t_steady is not None and last_done is not None and last_done > t_steady:
        wall = last_done - t_steady
        ms_per = wall / n_done * 1e3
        rtf = (n_done * C.HOP_LEN) / wall / C.SAMPLE_RATE
        print(
            f"Throughput: {n_done} windows in {wall:.2f} s = "
            f"{ms_per:.3f} ms/window ({rtf:,.1f}x real time, "
            f"steady-state after first batch)",
            file=sys.stderr,
        )


@contextlib.contextmanager
def profile_to(directory: str, device):
    """torch.profiler over the enclosed block (host ops, and CUDA kernels on
    a card); the Chrome trace goes to directory/trace.json. The throughput
    mode's device calls run on worker threads: their host ops are recorded
    where torch can profile all threads; CUDA kernels are recorded from
    every thread either way. The program's spans appear as `msk144.<name>`
    ranges on the threads that open them (runtime.metrics.trace_ranges)."""
    import os

    import torch
    from torch._C._profiler import _ExperimentalConfig

    from .runtime import metrics

    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        experimental = _ExperimentalConfig(profile_all_threads=True)
    except TypeError:  # a torch without the option: the main thread's host ops
        experimental = None
    os.makedirs(directory, exist_ok=True)
    with torch.profiler.profile(activities=activities,
                                experimental_config=experimental) as prof:
        with metrics.trace_ranges():
            yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(directory, "trace.json"))


if __name__ == "__main__":
    sys.exit(main())
