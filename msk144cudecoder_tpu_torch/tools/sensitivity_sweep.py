"""Decode-sensitivity sweep: which trials decode at each SNR, on the card
and, with --compare-cpu, on the CPU's plain path.

The port of the JAX package's tools/sensitivity_sweep.py. Each trial is one
5184-sample window (6 frames) of `CQ K1ABC FN42` at 1500 Hz in noise at the
given SNR, drawn from seed 1000 + t, so trial t is the same audio in both
packages (the port's stimulus equals the golden model's bit for bit). A
trial counts as decoded when a found row of its window unpacks to the
message. All trials of one SNR decode as one batch of windows.

The default protocol is the deep scan the JAX package pinned its floor at
(msk144cudecoder_tpu/config.py:78-113): width 500 Hz, step 1 Hz, depth 6,
K = 512 (the auto prefilter: 1024 rows), every 4th lag, 20 trials, SNRs 2
to -8 dB. Per-trial equality between two devices is expected at every SNR
but the noise floor, where the kernels' and the plain path's softbits,
which agree within 5e-3 relative, can flip a marginal trial. --fast-math
runs the sweep in the bf16 precision mode (DecoderConfig.fast_math, on the
card and, with --compare-cpu, on the CPU's fast plain path), the
counterpart of the JAX sweep's default; without it the sweep computes in
fp32, the JAX sweep's --exact.

Usage:
    python -m msk144cudecoder_tpu_torch.tools.sensitivity_sweep [--device cuda]
        [--compare-cpu] [--fast-math] [--trials 20] [--snrs 2,0,-2,-4,-6,-8]
        [--search-width 500]
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Sequence

import numpy as np
import torch

from .. import stimulus
from ..config import DecoderConfig
from ..ops import kernels, pipeline
from ..protocol import msg77
from ..runtime.decoder import to_host

MESSAGE = "CQ K1ABC FN42"
F0 = 1500.0
SEED0 = 1000
PROTOCOL = dict(search_width=500.0, search_step=1.0, scan_depth=6, max_survivors=512,
                scan_decimation=4)
SNRS = (2.0, 0.0, -2.0, -4.0, -6.0, -8.0)
TRIALS = 20


def trial_audio(snr_db: float, t: int) -> np.ndarray:
    """Trial t at snr_db: one window of 16-bit audio."""
    return stimulus.synthesize_audio_int16([(MESSAGE, F0)], 6, snr_db=snr_db,
                                           rng=np.random.default_rng(SEED0 + t))


def decodes_message(res, b: int) -> bool:
    """Whether a found row of window b unpacks to MESSAGE."""
    hashes = msg77.CallsignHashTable()
    for k in np.nonzero(res.found[b])[0]:
        ok, text = msg77.unpack77(pipeline.unpack_message_bits(res.message_bits[b][k]), hashes)
        if ok and text == MESSAGE:
            return True
    return False


def sweep(cfg: DecoderConfig, snrs: Sequence[float], trials: int,
          device=None) -> Dict[float, List[int]]:
    """snr -> the sorted indices of the trials that decode, on `device`
    (default: the card; "cpu" runs the plain path)."""
    dev = kernels.resolve_device(device)
    pipe = pipeline.DecodePipeline(cfg).to(dev)
    out = {}
    for snr in snrs:
        raw = np.stack([trial_audio(snr, t) for t in range(trials)])
        res = to_host(pipe(torch.from_numpy(raw).to(dev)))
        out[snr] = [t for t in range(trials) if decodes_message(res, t)]
    return out


def table(cfg: DecoderConfig, trials: int, results: Dict[str, Dict[float, List[int]]]) -> str:
    """The sweep's table: per SNR and device the count and the decoded
    trials, and with two devices the trials decoded on only one."""
    pre = pipeline.resolve_prefilter(cfg, cfg.num_candidates)
    lines = [f"message={MESSAGE!r} f0={F0:g} width={cfg.search_width:g} "
             f"step={cfg.search_step:g} depth={cfg.scan_depth} F={cfg.num_freqs} "
             f"K={cfg.max_survivors} pre={pre} dec={cfg.scan_decimation} "
             f"nbadsync<={cfg.nbadsync_threshold} trials={trials} (seeds {SEED0}-"
             f"{SEED0 + trials - 1}) precision={'bf16' if cfg.fast_math else 'fp32'}",
             f"{'SNR dB':>7} | {'device':<8} | {'decoded':>7} | {'share':>5} | trials"]
    devices = list(results)
    for snr in next(iter(results.values())):
        for name in devices:
            got = results[name][snr]
            lines.append(f"{snr:7.1f} | {name:<8} | {f'{len(got)}/{trials}':>7} | "
                         f"{100.0 * len(got) / trials:4.0f}% | {' '.join(map(str, got))}")
        if len(devices) == 2:
            diff = sorted(set(results[devices[0]][snr]) ^ set(results[devices[1]][snr]))
            lines.append(f"{snr:7.1f} | {'differ':<8} | {len(diff):>7} | {'':>5} | "
                         f"{' '.join(map(str, diff))}")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default), cuda:N or cpu (the plain path)")
    p.add_argument("--compare-cpu", action="store_true",
                   help="also run the same trials on the CPU's plain path")
    p.add_argument("--trials", type=int, default=TRIALS)
    p.add_argument("--snrs", default=",".join(f"{s:g}" for s in SNRS))
    p.add_argument("--search-width", type=float, default=PROTOCOL["search_width"],
                   help="Hz; narrower than the protocol's 500 only for a quick run on the CPU")
    p.add_argument("--fast-math", action="store_true",
                   help="bf16 inputs, f32 accumulation (DecoderConfig.fast_math); default fp32")
    args = p.parse_args(argv)

    cfg = DecoderConfig(**{**PROTOCOL, "search_width": args.search_width,
                           "fast_math": args.fast_math})
    snrs = [float(s) for s in args.snrs.split(",")]
    try:
        dev = kernels.resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    results = {str(dev): sweep(cfg, snrs, args.trials, dev)}
    if args.compare_cpu and dev.type != "cpu":
        results["cpu"] = sweep(cfg, snrs, args.trials, "cpu")
    print(table(cfg, args.trials, results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
