"""Kernel B1 on the card against another tree's: outputs, times in turns and
a phase split of the bf16 instantiation.

Run from the repository root on a machine with a card, with the base
tree's package unpacked in a git-ignored directory:

    git archive <commit> msk144cudecoder_tpu_torch | tar -x -C _checkout/base
    python -m msk144cudecoder_tpu_torch.tools.scan_compare --base _checkout/base \
        [--split] [--json out.json]

The base tree's kernels build from its own csrc/ into its own _build/. It
reports, and with --json writes:
  - ptxas's registers and spills of every scan kernel instance of this tree,
    and the HMMA (tensor-core) instructions in the SASS of each;
  - the bf16 kernel against scan_plain(fast=True) at every shape of
    run_hwtests.FAST_SCAN_CASES (check_scan's rule);
  - the float32 kernel against the base tree's, bit for bit, at every shape
    of run_hwtests.SCAN_CASES, and the float32 decode pipeline's outputs on
    the demo (default, full demod, deep) against the base tree's pipeline
    (one subprocess per tree);
  - at the main path's 64 windows (default and deep), ms per call queued,
    in turns (forward, then backward order): both trees' kernels, float32
    and bf16, at each frequency tile;
  - with --split, the phase split of both trees' bf16 kernels: copies of
    each tree's scan.cu, beside the base directory, that stop after the
    staging, after the correlation, after G and H, and after the slice
    maxima (a sink on what the phase wrote, then return), each built from
    its own sources and timed in turns with the whole kernel. A tree's
    phases are found by the source lines that end them (CUTS); in this
    tree's kernel the correlation includes G's phase ramp and stores, so
    "G and H" is the sync pairs alone.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops import kernels, scan
from . import run_hwtests as hw

ROOT = pathlib.Path(__file__).resolve().parents[2]
PHASES = ("staging", "correlation", "G and H", "slice maxima")


def _sink(value: str) -> str:
    return f"  if (({value}) == 1.2345e-30f) xb_out[blockIdx.x] = 1.f;\n  return;\n"


# the source line that ends each phase of B1's bf16 kernel, and the sink put
# before it: this tree's tensor-core kernel, then the SIMT kernel of
# earlier trees (kFast a template argument of scan_kernel)
CUTS = {
    "tensor cores": (
        ("  // the three products of the tile of lags",
         _sink("reinterpret_cast<const float*>(planes[0])[threadIdx.x]")),
        ("  __syncthreads();  // G is complete", _sink("G[threadIdx.x].x")),
        ("  slice_maxima<DEC>(G, t.nf, depth, smax, sarg);", _sink("G[threadIdx.x].x")),
        ("  top_k_rank<DEC>(smax, sarg, t, F, depth, num_cand, pos_out, xb_out);",
         _sink("smax[threadIdx.x % 21]"))),
    "simt": (
        ("  // the correlation at the lags whose taps never wrap",
         _sink("reinterpret_cast<const float*>(smem)[threadIdx.x]")),
        ("  __syncthreads();  // the window is read for the last time",
         "  float s_ = tail.x + tail.y;\n#pragma unroll\n  for (int u = 0; u < kLags; ++u)\n"
         "#pragma unroll\n    for (int ft = 0; ft < FT; ++ft) s_ += acc[u][ft].x + acc[u][ft].y;\n"
         + _sink("s_")),
        ("  // every pattern's (max, first argmax) per (frequency, slice)",
         _sink("G[threadIdx.x].x")),
        ("  // top-k slices per (f, p) by rank", _sink("smax[threadIdx.x % 21]"))),
}


def load_kernels(pkg_root: pathlib.Path, name: str):
    """A tree's ops/kernels.py as a module of its own (its library builds
    from that tree's csrc/)."""
    spec = importlib.util.spec_from_file_location(name, pkg_root / "ops" / "kernels.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def split_trees(pkg_root: pathlib.Path, dest: pathlib.Path, tag: str, source: str = "scan.cu",
                cuts: dict = CUTS, phases: tuple = PHASES) -> dict:
    """Copies of a package whose csrc/<source> stops after each phase: {phase:
    package root}. cuts holds each design's (anchor, sink) per phase, or a
    tuple of such pairs where the phase ends in several places (one per
    instantiation); the design is the one whose anchors all occur once in
    the source."""
    src = (pkg_root / "csrc" / source).read_text()

    def pairs(cut):
        return cut if isinstance(cut[0], tuple) else (cut,)

    design = next(c for c in cuts.values()
                  if all(src.count(a) == 1 for cut in c for a, _ in pairs(cut)))
    trees = {}
    for phase, cut in zip(phases, design):
        root = dest / f"split_{tag}_{phase.replace(' ', '_')}" / "msk144cudecoder_tpu_torch"
        shutil.rmtree(root.parent, ignore_errors=True)
        shutil.copytree(pkg_root, root, ignore=shutil.ignore_patterns("_build", "__pycache__"))
        cut_src = src
        for anchor, sink in pairs(cut):
            cut_src = cut_src.replace(anchor, sink + anchor)
        (root / "csrc" / source).write_text(cut_src)
        trees[phase] = root
    return trees


def template_args(mangled: str, kernel: str):
    """A kernel instance's template arguments ("4,4" for <4, 4>, "1" for
    <true>) from its mangled name, or None if the name is not kernel's."""
    m = re.search(rf"{len(kernel)}{kernel}I((?:L[ib]-?\d+E)+)E", mangled)
    return ",".join(re.findall(r"L[ib](-?\d+)E", m.group(1))) if m else None


SCAN_KERNELS = ("scan_kernel", "scan_fast_kernel")


def build_report(lib_path: pathlib.Path, names: tuple = SCAN_KERNELS) -> dict:
    """{kernel: {"template arguments": [registers, spill-store bytes,
    spill-load bytes, HMMA instructions]}} of the named kernels' instances
    in the library (the scan kernels' arguments are "dec,tile")."""
    rep: dict = {}
    cur = None
    for ln in lib_path.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in ln:
            cur = next(((k, a) for k in names if (a := template_args(ln, k))), None)
            if cur:
                rep.setdefault(cur[0], {})[cur[1]] = [0, 0, 0, 0]
        elif cur and "spill stores" in ln:
            st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln).groups()
            rep[cur[0]][cur[1]][1:3] = [int(st), int(ld)]
        elif cur and "Used" in ln:
            rep[cur[0]][cur[1]][0] = int(re.search(r"Used (\d+) registers", ln).group(1))
    cuobjdump = pathlib.Path(kernels.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    cur = None
    for ln in sass.splitlines():
        if "Function :" in ln:
            cur = next(((k, a) for k in rep if (a := template_args(ln, k)) in rep[k]), None)
        elif cur and re.search(r"\bHMMA\b", ln):
            rep[cur[0]][cur[1]][3] += 1
    return rep


def queued_ms(fn, reps: int = 20) -> float:
    """ms per call of fn() back to back behind a device-side sleep."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e6 + 2e5 * reps))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(runs: dict) -> dict:
    """{name: [ms forward, ms backward]} over the runs in turns."""
    times = {n: [] for n in runs}
    for order in (list(runs), list(runs)[::-1]):
        for n in order:
            times[n].append(round(queued_ms(runs[n]), 4))
    return times


PIPELINE_OUTPUTS = r'''
import sys, numpy as np, torch
sys.path.insert(0, ".")
from msk144cudecoder_tpu_torch import stimulus
from msk144cudecoder_tpu_torch.config import DecoderConfig
from msk144cudecoder_tpu_torch.tools.run_hwtests import DEEP
torch.backends.cuda.matmul.allow_tf32 = False
from msk144cudecoder_tpu_torch.ops import pipeline
w = stimulus.stream_windows(np.fromfile(sys.argv[2], dtype=np.int16))
res = {}
for name, cfg in (("default", DecoderConfig()), ("full demod", DecoderConfig(survivor_prefilter=0)),
                  ("deep", DEEP)):
    r = pipeline.DecodePipeline(cfg).to("cuda")(torch.from_numpy(w).to("cuda"))
    res[name] = {f: getattr(r, f).cpu() for f in r._fields}
torch.save(res, sys.argv[1])
'''


def pipeline_outputs(tree: pathlib.Path, out: pathlib.Path) -> dict:
    """The float32 pipeline's outputs on the demo, computed by the package
    under `tree` in a process of its own."""
    subprocess.run([sys.executable, "-c", PIPELINE_OUTPUTS, str(out), str(hw.DEMO)], cwd=tree,
                   check=True, timeout=900)
    return torch.load(out)


def pipelines_equal(base: pathlib.Path) -> dict:
    """{config: whether the float32 pipeline's outputs on the demo are bit
    for bit those of the package under `base`}, for the default, full-demod
    and deep configs."""
    with tempfile.TemporaryDirectory() as tmp:
        a = pipeline_outputs(base, pathlib.Path(tmp) / "base.pt")
        b = pipeline_outputs(ROOT, pathlib.Path(tmp) / "this.pt")
    return {n: all(torch.equal(a[n][f], b[n][f]) for f in a[n]) for n in a}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--base", required=True, type=pathlib.Path,
                   help="a directory holding the base tree's msk144cudecoder_tpu_torch/")
    p.add_argument("--split", action="store_true", help="the phase split of both bf16 kernels")
    p.add_argument("--json", type=pathlib.Path, help="also write the report here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("scan_compare: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    report: dict = {"card": hw.card_line()}
    print(report["card"], flush=True)

    this_pkg, base_pkg = ROOT / "msk144cudecoder_tpu_torch", args.base / "msk144cudecoder_tpu_torch"
    trees = {"base": base_pkg}
    if args.split:
        for tag, pkg in (("base", base_pkg), ("this", this_pkg)):
            trees.update({f"{tag} {ph}": r for ph, r in
                          split_trees(pkg, args.base.parent, tag).items()})
    mods = {n: load_kernels(r, f"scan_compare_{i}") for i, (n, r) in enumerate(trees.items())}
    with ThreadPoolExecutor(len(mods)) as pool:  # the builds, side by side
        libs = dict(zip(mods, pool.map(lambda m: m.library(), mods.values())))
    libs["this"] = kernels.library()
    report["build"] = build_report(kernels.library_path())
    print("ptxas [registers, spill stores, spill loads] and HMMA per instance:",
          json.dumps(report["build"]), flush=True)

    rng = np.random.default_rng(2026)
    for cfg, nw in hw.FAST_SCAN_CASES:
        pipe, c = hw.kernel_windows(cfg, nw, rng, dev)
        report[f"check {hw.scan_name(cfg, nw)}"] = stats = hw.check_scan(pipe, c)[0]
        print("check_scan", hw.scan_name(cfg, nw), stats, flush=True)

    def runner(lib, pipe, c, cfg, out, ft, fast):
        nw, F = c.shape[0], pipe.B.shape[1]
        a = (c.data_ptr(), pipe.B.data_ptr(), pipe.E_dec.data_ptr(), pipe.chi.data_ptr(),
             out[0].data_ptr(), out[1].data_ptr(), nw, F, cfg.scan_depth,
             cfg.candidates_per_pattern, cfg.scan_decimation, ft, int(fast))

        def run():
            kernels.raise_on_error("msk_scan", lib.msk_scan(*a, kernels.stream_ptr(dev)))
        return run

    for cfg, nw in hw.SCAN_CASES:
        pipe, c = hw.kernel_windows(cfg, nw, rng, dev)
        F, dec = pipe.B.shape[1], cfg.scan_decimation
        shape = (nw, F, cfg.scan_depth, cfg.candidates_per_pattern)
        out = (torch.empty(shape, dtype=torch.int32, device=dev),
               torch.empty(shape, dtype=torch.float32, device=dev))
        ft = scan.scan_tile(nw, F, dec, kernels.num_sms(dev))
        runner(libs["base"], pipe, c, cfg, out, ft, False)()
        pos, xb = scan.scan_cuda(c, pipe.B, pipe.E_dec, pipe.chi, cfg.scan_depth,
                                 cfg.candidates_per_pattern, dec)
        same = bool(torch.equal(out[0], pos) and torch.equal(out[1], xb))
        report[f"float32 bit for bit {hw.scan_name(cfg, nw)}"] = same
        print("float32 bit for bit with the base", hw.scan_name(cfg, nw), same, flush=True)
        if nw != 64:
            continue
        runs = {f"{tree} {prec} tile {t}": runner(libs[tree], pipe, c, cfg, out, t, fast)
                for t in scan.FREQ_TILES for prec, fast in (("float32", False), ("bf16", True))
                for tree in ("base", "this")}
        report[f"turns {hw.scan_name(cfg, nw)}"] = t = in_turns(runs)
        print("in turns, ms queued", hw.scan_name(cfg, nw), f"(tile {ft} chosen):",
              json.dumps(t), flush=True)
        if args.split:
            for tag in ("base", "this"):
                runs = {**{ph: runner(libs[f"{tag} {ph}"], pipe, c, cfg, out, ft, True)
                           for ph in PHASES},
                        "whole": runner(libs[tag], pipe, c, cfg, out, ft, True)}
                report[f"split {tag} {hw.scan_name(cfg, nw)}"] = t = in_turns(runs)
                print(f"phase split, {tag} bf16 tile {ft}, ms queued", hw.scan_name(cfg, nw),
                      json.dumps(t), flush=True)

    report["pipeline float32 bit for bit"] = same = pipelines_equal(args.base)
    print("float32 pipeline outputs on the demo bit for bit with the base", same, flush=True)
    if args.json:
        args.json.write_text(json.dumps(report, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
