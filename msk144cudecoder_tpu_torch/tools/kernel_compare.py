"""Kernels B2 (survivor demod), B3 (LDPC BP) and B4 (full demod) on the card
against another tree's: outputs, times in turns and a phase split; every
kernel instantiation and the float32 pipeline against the other tree's, bit
for bit.

Run from the repository root on a machine with a card, with the base
tree's package unpacked in a git-ignored directory:

    git archive <commit> msk144cudecoder_tpu_torch | tar -x -C _checkout/base
    python -m msk144cudecoder_tpu_torch.tools.kernel_compare --base _checkout/base \
        [--kernel survivor] [--kernel bp] [--kernel demod] [--split] [--json out.json] \
        [--tree NAME=DIR ...]

The base tree's kernels build from its own csrc/ into its own _build/; its C
entry points must take this tree's arguments (kernels.SIGNATURES), since
this tree's wrappers call them. It reports, and with --json writes:
  - ptxas's registers and spills of every survivor_kernel, bp_kernel and
    demod_kernel instance of both trees, and the HMMA (tensor-core)
    instructions in the SASS of each;
  - at every shape of the battery (run_hwtests: SCAN_CASES, SURVIVOR_CASES,
    the bp_inputs rows, DEMOD_CASES, and their bf16 counterparts) each
    kernel of this tree against its plain version by the battery's rule,
    and its outputs against the base tree's kernel on the same inputs, bit
    for bit or not;
  - at the main path's shapes (B2: 64 windows x 512 rows, default and deep;
    B3: the main path's 16,384 rows of 64 windows in each precision, and
    4096 planted rows; B4: the deep scan's 64 windows, every candidate of
    each precision's scan), ms per call queued, in turns (forward, then
    backward order): both trees' kernels in float32 and bf16;
  - with --split, the phase split of both trees' kernels: copies of each
    tree's source, beside the base directory, that stop after each phase
    but the last (B2: staging, mix, carrier, then the tail; B3, each
    iteration: the per-bit sum with the parity and CRC gate, the tanh-log2
    pass, the check sums, then the leave-one-out; B4: z and the pattern
    sums, packed in bf16, then the tails), each built from its own sources
    and timed in turns with the whole kernel, in both precisions. A B2 cut
    ends each row after the phase, a B3 cut each iteration (so a cut B3
    runs every valid row that fails at iteration 0 to the last iteration,
    where the whole kernel stops at a row's first success), a B4 cut each
    pattern (float32) or cell (bf16). A tree's phases are found by the
    source lines that end them (CUTS);
  - the float32 pipeline's outputs on the demo (default, full demod, deep)
    against the base tree's pipeline (scan_compare.pipelines_equal);
  - with --tree, other trees (other designs, under git-ignored directories)
    built and timed in turns beside both at the same shapes, their outputs
    there bit for bit with this tree's or not.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import constants as C
from ..ops import demod, kernels, ldpc, pipeline, scan, survivor
from . import run_hwtests as hw
from . import scan_compare as sc

ROOT = sc.ROOT
KERNELS = {"survivor": ("survivor.cu", "survivor_kernel"), "bp": ("bp.cu", "bp_kernel"),
           "demod": ("demod.cu", "demod_kernel")}
PHASES = {"survivor": ("staging", "mix", "carrier"),
          "bp": ("per-bit sum", "tanh-log2 pass", "check sums"),
          "demod": ("z and pattern sums",)}


def _row_sink(value: str) -> str:
    return f"    if (({value}) == 1.2345e-30f) sb_out[row * 128] = 1.f;\n"


_ITER_SINK = "      if (z == 1.2345e-30f) nerr_out[row] = -1;\n      continue;\n"
_MIX_SINK = ("    {\n      float s_ = 0.f;\n#pragma unroll\n"
             "      for (int n = 0; n < kFrameLen / 32; ++n)\n"
             "        s_ += reinterpret_cast<const float&>(acc[n]);\n"
             + _row_sink("s_") + "    }\n    cp_async_wait_all();\n    continue;\n")
# B4: a float32 pattern's tails, then kFast's tails of every pattern
_F32_TAILS = ("    for (int j = warp; j < K; j += kWarps) {\n      const size_t row",
              "    if (reinterpret_cast<const float*>(za)[threadIdx.x] == 1.2345e-30f)\n"
              "      sb_out[cell] = 1.f;\n    continue;\n")
_FAST_TAILS = ("  for (int t = warp; t < rows; t += kFastWarps) {\n",
               "  if (zp[threadIdx.x] == 0x12345u) sb_out[cell] = 1.f;\n  return;\n")
_STAGING = ("  for (; s < s_end; s += warps) {\n",
            "  if (reinterpret_cast<const float*>(smem)[threadIdx.x] == 1.2345e-30f)\n"
            "    sb_out[0] = 1.f;\n  return;\n")

# the source line that ends each phase but the last, and the sink put
# before it, per design: B2 with the bf16 frame packed (its tail on the
# tensor cores) or as float2 (earlier trees); B3 with each edge's two bf16
# log2 parts in one word, or in two arrays (earlier trees); B4 with its bf16
# pattern sums packed, all before the tails (a tail loop per instantiation,
# each cut), or both instantiations on the float32 sums (earlier trees)
CUTS = {
    "survivor": {
        "packed frame": (
            _STAGING,
            ("    // times the carrier W[f, l]\n", _MIX_SINK),
            ("    // the matched-filter tail\n",
             _row_sink("reinterpret_cast<const float*>(fr)[lane]") + "    __syncwarp();\n"
             "    continue;\n")),
        "float2 frame": (
            _STAGING,
            ("    // times the carrier W[f, l]\n", _MIX_SINK),
            ("    warp_tail<kFast>(frame,",
             _row_sink("reinterpret_cast<const float*>(frame)[lane]") + "    __syncwarp();\n"
             "    continue;\n")),
    },
    "bp": {
        "one word per edge": (
            ("      // bit -> check messages and their log-domain magnitudes\n", _ITER_SINK),
            ("      // the check sums\n", _ITER_SINK),
            ("      // check -> bit messages (leave-one-out)\n", _ITER_SINK)),
        "two arrays": (
            ("      // bit -> check messages and their log-domain magnitudes\n", _ITER_SINK),
            ("      if (j < kChecks) {\n        int neg", _ITER_SINK),
            ("      // check -> bit messages (leave-one-out)\n", _ITER_SINK)),
    },
    "demod": {
        "packed bf16 sums": ((_F32_TAILS, _FAST_TAILS),),
        "float32 sums only": (_F32_TAILS,),
    },
}


@contextlib.contextmanager
def use_library(lib):
    """This tree's wrappers launch on lib (another tree's library) inside."""
    saved = kernels._lib
    kernels._lib = lib
    try:
        yield
    finally:
        kernels._lib = saved


def on(lib, fn, *args):
    """A call of fn(*args) with its kernels from lib."""
    def run():
        with use_library(lib):
            return fn(*args)
    return run


def outputs_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def kernel_cases(rng, dev):
    """(name, wrapper, arguments, this tree's outputs, statistics) of every
    kernel instantiation at every battery shape, each held against its plain
    version by the battery's rule on the way."""
    for cfg, nw in hw.SCAN_CASES + hw.FAST_SCAN_CASES:
        pipe, c = hw.kernel_windows(cfg, nw, rng, dev)
        stats, args = hw.check_scan(pipe, c)
        yield hw.scan_name(cfg, nw), scan.scan_cuda, args, scan.scan_cuda(*args), stats
    for cfg, nw, plant in hw.SURVIVOR_CASES + hw.FAST_SURVIVOR_CASES:
        pipe, c = hw.kernel_windows(cfg, nw, rng, dev)
        stats, args, out = hw.check_survivor(pipe, c, plant)
        yield (hw.survivor_name(cfg, nw, args[3].shape[1], plant), survivor.demod_survivors_cuda,
               args, out, stats)
    for fast in (False, True):
        for tag, llr, valid, lt in hw.bp_inputs(rng, dev, fast):
            stats, out = hw.check_bp(tag, llr, valid, lt, fast)
            yield (hw.bp_name(tag, llr.shape[0], fast), ldpc.bp_decode_cuda,
                   (llr, valid, lt, C.NUM_BP_ITERATIONS, fast), out, stats)
    for cfg, nw in hw.DEMOD_CASES + hw.FAST_DEMOD_CASES:
        pipe, c = hw.kernel_windows(cfg.replace(survivor_prefilter=0), nw, rng, dev)
        stats, args, _, out = hw.check_demod(pipe, c)
        yield (hw.demod_name(pipe.cfg, nw, stats["rows"]), demod.demod_candidates_cuda, args,
               out, stats)
        torch.cuda.empty_cache()


def timing_cases(kernel: str, rng, dev):
    """(shape name, {"float32": (wrapper, arguments), "bf16": ...}) of a
    kernel at the main path's shapes."""
    if kernel == "survivor":
        for cfg, nw, plant in hw.SURVIVOR_CASES[:2]:
            _, c = hw.kernel_windows(cfg, nw, rng, dev)
            calls = {}
            for prec, fast in (("float32", False), ("bf16", True)):  # each mode's own rows
                pipe = pipeline.DecodePipeline(cfg.replace(fast_math=fast)).to(dev)
                front = pipe.prefilter(*pipe.scan(c))
                calls[prec] = (survivor.demod_survivors_cuda,
                               (c, pipe.W, pipe.chi, *front[1:4], pipe.demod_tables, fast))
            yield hw.survivor_name(cfg, nw, front[1].shape[1], plant), calls
    elif kernel == "demod":
        cfg, nw = hw.DEMOD_CASES[0]
        cfg = cfg.replace(survivor_prefilter=0)
        _, c = hw.kernel_windows(cfg, nw, rng, dev)
        calls = {}
        for prec, fast in (("float32", False), ("bf16", True)):  # each mode's own candidates
            pipe = pipeline.DecodePipeline(cfg.replace(fast_math=fast)).to(dev)
            pos = pipe.scan(c)[0].contiguous()
            calls[prec] = (demod.demod_candidates_cuda, (c, pipe.W, pos, pipe.demod_tables, fast))
        yield hw.demod_name(cfg, nw, pos.numel()), calls
    else:
        rows = {fast: hw.bp_inputs(rng, dev, fast) for fast in (False, True)}
        for i in range(2):
            calls = {prec: (ldpc.bp_decode_cuda, (*rows[fast][i][1:], C.NUM_BP_ITERATIONS, fast))
                     for prec, fast in (("float32", False), ("bf16", True))}
            yield f"bp ({rows[False][i][0]}, {rows[False][i][1].shape[0]} rows)", calls


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--base", required=True, type=pathlib.Path,
                   help="a directory holding the base tree's msk144cudecoder_tpu_torch/")
    p.add_argument("--kernel", action="append", choices=list(KERNELS),
                   help="the kernels to time and split (default: all three)")
    p.add_argument("--split", action="store_true", help="the phase split of both trees' kernels")
    p.add_argument("--json", type=pathlib.Path, help="also write the report here")
    p.add_argument("--tree", action="append", default=[], metavar="NAME=DIR",
                   help="another tree (DIR holds its msk144cudecoder_tpu_torch/) to time in turns")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_compare: no CUDA device", file=sys.stderr)
        return 1
    chosen = args.kernel or list(KERNELS)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    report: dict = {"card": hw.card_line()}
    print(report["card"], flush=True)

    this_pkg, base_pkg = ROOT / "msk144cudecoder_tpu_torch", args.base / "msk144cudecoder_tpu_torch"
    others = {name: pathlib.Path(d) / "msk144cudecoder_tpu_torch"
              for name, d in (t.split("=", 1) for t in args.tree)}
    trees = {"base": base_pkg, **others}
    if args.split:
        for k in chosen:
            for tag, pkg in (("base", base_pkg), ("this", this_pkg)):
                cuts = sc.split_trees(pkg, args.base.parent, f"{tag}_{k}", KERNELS[k][0],
                                      CUTS[k], PHASES[k])
                trees.update({f"{tag} {k} {ph}": r for ph, r in cuts.items()})
    mods = {n: sc.load_kernels(r, f"kernel_compare_{i}") for i, (n, r) in enumerate(trees.items())}
    with ThreadPoolExecutor(4) as pool:  # the builds, four libraries at a time
        libs = dict(zip(mods, pool.map(lambda m: m.library(), mods.values())))
    libs["this"] = kernels.library()
    names = tuple(name for _, name in KERNELS.values())
    report["build"] = {tree: sc.build_report(path, names) for tree, path in
                       (("this", kernels.library_path()),
                        *((t, mods[t].library_path()) for t in ("base", *others)))}
    print("ptxas [registers, spill stores, spill loads] and HMMA per instance:",
          json.dumps(report["build"]), flush=True)

    rng = np.random.default_rng(2026)
    for name, fn, fargs, out, stats in kernel_cases(rng, dev):
        same = outputs_equal(out, on(libs["base"], fn, *fargs)())
        report[f"check {name}"] = {**stats, "bit for bit with the base": same}
        print(f"{name}: {stats}; bit for bit with the base: {same}", flush=True)
        del out, fargs

    for k in chosen:
        for shape, calls in timing_cases(k, rng, dev):
            for tree in others:
                report[f"{tree} bit for bit {shape}"] = same = all(
                    outputs_equal(fn(*a), on(libs[tree], fn, *a)()) for fn, a in calls.values())
                print(f"{tree} bit for bit with this, {shape}: {same}", flush=True)
            runs = {f"{tree} {prec}": on(libs[tree], fn, *a) for prec, (fn, a) in calls.items()
                    for tree in ("base", "this", *others)}
            report[f"turns {shape}"] = t = sc.in_turns(runs)
            print(f"in turns, ms queued, {shape}:", json.dumps(t), flush=True)
            if not args.split:
                continue
            for tag in ("base", "this"):
                for prec, (fn, a) in calls.items():
                    runs = {**{ph: on(libs[f"{tag} {k} {ph}"], fn, *a) for ph in PHASES[k]},
                            "whole": on(libs[tag], fn, *a)}
                    report[f"split {tag} {prec} {shape}"] = t = sc.in_turns(runs)
                    print(f"phase split, {tag} {prec}, ms queued, {shape}:", json.dumps(t),
                          flush=True)
    report["pipeline float32 bit for bit"] = same = sc.pipelines_equal(args.base)
    print("float32 pipeline outputs on the demo bit for bit with the base", same, flush=True)
    if args.json:
        args.json.write_text(json.dumps(report, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
