"""One run of one cell: set-up, the measured window, the check, the last line.

`Cell` finds a cell's files by the names BENCHMARK.json gives them;
`run_cell` runs it on a device. The order of a run:

 1. set-up: the recording from the seed, the port's native framer over it
    (a run fails when the framer did not build), the port's StreamDecoder
    for the configuration (the kernels build or load from the port's
    `_build/`), and the driver's entry (`drivers/<name>.py`) on the stream's
    first windows, which warms every shape the window uses; `setup_s` ends
    here;
 2. the window: the driver feeds the rest of the stream to the entry for
    `seconds`; with `trace` the program's spans are on, the profiler takes a
    slice in its middle and the harness labels its calls into the port;
 3. the device's peak memory is read and the program's state freed;
 4. the plain reference checks a sample of the window's answers
    (compare.py) against the cell's limits;
 5. the metrics the cell reports are read by their readers in `metrics/`.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import time
from typing import Dict, Optional

import numpy as np

from . import compare, drivers, generator, reference, spans, trace

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
SPANS_ENV = "MSK144_TPU_METRICS"


class Cell:
    """A workload of BENCHMARK.json with its configuration, traffic mix,
    limits and the metrics it reports."""

    def __init__(self, name: str):
        spec = json.loads((ROOT / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"error: no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.spec = cells[name]
        conf = {c["name"]: c for c in spec["configs"]}[self.spec["config"]]
        self.config = json.loads((ROOT / conf["file"]).read_text())
        self.traffic = json.loads((BENCH / "traffic" / f"{self.spec['traffic']}.json").read_text())
        self.limits = json.loads((BENCH / "limits" / f"{name}.json").read_text())

        def mine(m):
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in spec["end_to_end"] if mine(m)]
        self.per_layer = [m for m in spec["per_layer"] if mine(m)]


def reader(metric: str):
    """The `read(run)` function of metrics/<metric>.py."""
    path = BENCH / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(f"bench_torch_metric_{metric}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


class Run:
    """What a run measured, as the metric readers see it."""

    def __init__(self, cell: Cell, settings: reference.Settings):
        self.cell = cell
        self.settings = settings
        self.setup_s = 0.0
        self.window: Optional[drivers.Window] = None
        self.answered = 0
        self.spans: Optional[spans.SpanSink] = None
        self.slice: Optional[trace.Slice] = None
        self.check: Dict = {}

    def span_ms_per_window(self, name: str) -> Optional[float]:
        """The program's span `name`, summed over the window, per window."""
        if self.spans is None or name not in self.spans.ms or not self.window.windows:
            return None
        return self.spans.ms[name] / self.window.windows


def card_state() -> Dict:
    """The card's name, power limit and clocks, as nvidia-smi reads them."""
    q = "name,power.limit,clocks.sm,clocks.mem,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    first = out.strip().splitlines()[:1]
    return dict(zip(q.split(","), (v.strip() for v in first[0].split(",")))) if first else {}


def run_cell(workload: str, seed: int, seconds: float, trace_on: bool, device: str,
             t_start: float, control: bool = False, decoder_base=None,
             hops: Optional[int] = None, traffic_overrides: Optional[Dict] = None,
             config_overrides: Optional[Dict] = None) -> Dict:
    """One run; returns the result line's object. `control` decodes in the
    port's bf16 mode (the lower precision the check must refuse);
    `decoder_base` replaces the port's StreamDecoder class, `hops` the
    recording's length, `traffic_overrides` entries of the traffic file
    (the CPU checks run small) and `config_overrides` keywords of the
    configuration's decoder (the CPU checks of another path)."""
    import torch

    from msk144cudecoder_tpu_torch.config import DecoderConfig
    from msk144cudecoder_tpu_torch.runtime import StreamDecoder, native

    cell = Cell(workload)
    cell.traffic = traffic = {**cell.traffic, **(traffic_overrides or {})}
    driver = drivers.load(traffic["driver"])
    if not native.available():
        raise SystemExit("error: the port's native framer (runtime/native.py) did not build; "
                         "the benchmark times no other framer")
    decoder_kw = {**cell.config["decoder"], **(config_overrides or {})}
    settings = reference.Settings.from_config(decoder_kw)
    run = Run(cell, settings)
    rec = generator.make(seed, traffic, settings.freqs, hops)

    dev = torch.device(device)
    label = None
    if trace_on:
        run.slice = trace.Slice(dev.type)

        def label(name):
            return torch.profiler.record_function(name) if run.slice.active else contextlib.nullcontext()

    warm_n = int(traffic["warmup_windows"])
    base = decoder_base or StreamDecoder
    cls = drivers.recorder(base, warm_n, int(traffic["check_windows"]), seed, label)
    cfg = DecoderConfig(**{**decoder_kw, "fast_math": bool(control)})
    decoder = cls(cfg, dev)
    stream = drivers.Replay(rec.audio.tobytes())
    windows = native.native_window_stream(stream, 1)
    sink = spans.LineSink()
    driver.warm(decoder, windows, traffic, warm_n, sink)
    if trace_on:
        run.slice.warm()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    run.setup_s = time.perf_counter() - t_start

    clock = drivers.Clock(seconds, run.slice, traffic["profile_start"], traffic["profile_seconds"],
                          label)
    err = contextlib.nullcontext()
    if trace_on:
        run.spans = spans.SpanSink()
        os.environ[SPANS_ENV] = "1"
        err = contextlib.redirect_stderr(run.spans)
    try:
        with err:
            run.window = driver.run(decoder, windows, traffic, clock, sink)
    finally:
        os.environ.pop(SPANS_ENV, None)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_reserved(dev)
    else:
        peak = 0
    run.answered = decoder.answered - warm_n
    kept = list(cls.kept)
    del decoder, windows
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    got = compare.compare(rec, settings, kept, dev)
    run.check = got
    numbers = {"unanswered": run.window.windows - run.answered,
               **{k: v for k, v in got.items() if k != "info"}}
    checks = {}
    correct = True
    for name, value in numbers.items():
        limit = cell.limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is not None and (value is None or value > limit):
            correct = False

    wanted = cell.per_layer if trace_on else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": run.window.windows,
           "failed": numbers["unanswered"], "metrics": metrics, "device": device_info}
    if trace_on and run.slice.done:
        device_info["busy_s"] = run.slice.busy_s()
        device_info["window_s"] = run.slice.window_s
        out["breakdown"] = {"device_ops": run.slice.top_ops(), "idle_gaps": run.slice.idle_gaps()}
    card = card_state() if dev.type == "cuda" else {}
    out["info"] = {"workload": workload, "seed": seed, "seconds": seconds, "trace": int(trace_on),
                   "control": int(control), "setup_s": run.setup_s,
                   "windows": run.window.windows, "wall_s": run.window.wall_s,
                   "windows_per_second": run.window.per_second,
                   "pings": len(rec.pings), "stdout_lines": sink.lines, "card": card,
                   "check": got["info"]}
    out["checks"] = checks
    return out


def print_result(out: Dict) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out, default=_plain), flush=True)


def _plain(x):
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    raise TypeError(type(x))
