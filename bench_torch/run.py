"""Run one cell of the port's benchmark once.

    python3 bench_torch/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the compared numbers as the last lines of standard error and one JSON
object as the last line of standard output (see common/harness.py). Needs a
CUDA card: without one, or without the port beside the benchmark, it exits
non-zero and prints no result. `--control 1` decodes in the port's bf16
mode, the lower precision the check has to refuse; the benchmark's own runs
never set it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("error: the benchmark needs a CUDA card; none is available", file=sys.stderr)
        return 2
    try:
        import msk144cudecoder_tpu_torch  # noqa: F401
    except ImportError:
        print("error: the port (msk144cudecoder_tpu_torch) is not beside the benchmark",
              file=sys.stderr)
        return 2
    from bench_torch.common import harness

    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                           T_START, control=bool(args.control))
    harness.print_result(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
