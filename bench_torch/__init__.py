"""The benchmark of the PyTorch/CUDA port (`msk144cudecoder_tpu_torch`).

One command runs one cell once:

    python3 bench_torch/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cells, metrics and bounds are listed in BENCHMARK.json at the root of
the repository. Each configuration (`configs/<name>.json`), traffic mix
(`traffic/<name>.json`), per-layer metric (`metrics/<name>.py`) and cell's
correctness limits (`limits/<workload>.json`) is a file of its own, found by
the name BENCHMARK.json gives it; a traffic file names its driver, the
port's entry point the window runs (`drivers/<name>.py`). `common/` holds
what they share: the generator, the recorder and clock the drivers use, the
plain reference, the comparison, the trace reader and the roofline
arithmetic.
"""
