"""Command-line interface: stdin samples in, decoded message lines out.

The flags, defaults, banner and output line of the JAX package's CLI
(msk144cudecoder_tpu/cli.py), which mirror the reference decoder. The port
differs in three ways: `--device` (default cuda) replaces `--platform`; the
banner says `Precision: fp32`, since the port computes in float32 whatever
`--exact-math` says; and `--window-batch > 1` decodes each batch
synchronously (no worker pool yet), with the numpy framer.
"""

from __future__ import annotations

import argparse
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
                   help="accepted for compatibility; batches run one at a "
                        "time in this port")
    p.add_argument("--exact-math", action="store_true",
                   help="accepted for compatibility; the port always "
                        "computes in fp32")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to decode on: cuda (default), cuda:N "
                        "or cpu (the kernels' plain torch versions)")
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
        fast_math=not args.exact_math,
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
        "Precision: fp32",
        f"Device: {device}",
        "",
    ]
    print("\n".join(lines), file=out)


def resolve_device(name: str):
    """The torch device to decode on. A CUDA device that is not there is an
    error, never a silent switch to the CPU."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"error: --device={name} but no CUDA device is available "
            "(pass --device=cpu to run the plain torch path on the CPU)")
    if device.type not in ("cuda", "cpu"):
        raise SystemExit(f"error: unsupported --device={name}: use cuda or cpu")
    return device


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    device = resolve_device(args.device)
    print_banner(cfg, device)

    import numpy as np

    from .runtime import StreamDecoder
    from .runtime.metrics import ScopedMetric, SimpleTimer
    from .runtime.stream import window_stream

    decoder = StreamDecoder(cfg, device)
    windows = window_stream(sys.stdin.buffer, cfg.read_mode)

    def emit(results, ms: float, n_windows: int):
        budget = C.LOOP_SOFT_BUDGET_MS * n_windows
        if ms > budget:
            print(
                f"Warning: Working loop takes too much time: {ms:.0f} ms"
                f" of {budget:.0f} ms max.",
                file=sys.stderr,
            )
        for item in results:
            print(item.format_line(), flush=True)

    if cfg.window_batch <= 1:
        # depth-1 pipelining: the next window's device work is enqueued
        # before the previous one's results are fetched and post-processed
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
    else:
        # throughput mode, synchronous: one device call per batch of
        # window_batch windows, the stream tail zero-padded and its pad
        # results dropped
        def run(batch_list, n_valid: int):
            timer = SimpleTimer()
            pad = [np.zeros_like(batch_list[0])] * (cfg.window_batch - len(batch_list))
            for results in decoder.decode_many(np.stack(batch_list + pad), n_valid):
                emit(results, 0.0, 1)
            emit([], timer.milliseconds_elapsed(), n_valid)

        batch: list = []
        for window in windows:
            batch.append(window)
            if len(batch) == cfg.window_batch:
                run(batch, len(batch))
                batch = []
        if batch:
            run(batch, len(batch))

    print("Done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
