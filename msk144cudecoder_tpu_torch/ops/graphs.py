"""CUDA graphs of DecodePipeline: the port's counterpart of `jax.jit`.

The JAX package runs a whole pass as one compiled XLA program (the `jax.jit`
of decode_raw, msk144cudecoder_tpu/ops/pipeline.py:664, and of its sharded
form, parallel/sharding.py:145). The port's pass is about 190 eager
launches, most of them small glue ops, whose host cost is most of a pass on
the card. GraphedPipeline captures a built DecodePipeline's forward once per
(raw batch shape, dtype, CUDA stream) as a torch.cuda.CUDAGraph and replays
it for every later pass of that key: one graph launch per pass.

The first call for a key builds the kernel library and runs the eager
forward on the caller's stream, which creates what a capture must find made
(cuFFT plans, cub temp storage, the kernels' once-per-device shared-memory
opt-ins); its result is that call's. Then the input is copied into a static
tensor and forward is captured. Every later call copies its input into the
static tensor and replays. The graph packs its outputs into one static
byte buffer (PackedResult), which each call copies out before it hands it
over, to the device or to pinned host memory: the results of two replays in
flight are never aliases, and a fetch is one copy.

Graphs and streams: each key has its own graph and its own memory pool
(torch.cuda.graph's private pool), and a graph replays only on its key's
stream, so two worker threads never replay one graph; a call enqueues its
copy in, replay and copy out under the graph's lock. The key's stream is the
capture stream, but for the legacy default stream, which cannot capture: its
key captures on a side stream and replays on the default stream. Captures
take a process-wide lock, one at a time, and run in capture_error_mode
"thread_local", so that another worker's pin_memory, allocation or
synchronize during a capture neither breaks it nor is refused.

Spans: run names a pass by the lookup that picks its graph (graph_for) and
opens it with the caller's span factory, so this module imports no tracing.

Launch counts: a capture launches nothing, so under kernels.recording() the
wrappers' counts go to the graph's tally, and each replay adds the tally: the
counts stay the launches made, one pass's worth per call.

A capture or replay that fails raises; nothing falls back to the eager
path. A pipeline on the CPU raises (CPU tensors have no graphs: the CPU runs
DecodePipeline eagerly).
"""

from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple

import torch

from . import kernels
from .pipeline import DecodePipeline, WindowDecodeResult

_capture_lock = threading.Lock()  # one capture at a time in the process


class PackedResult(NamedTuple):
    """A WindowDecodeResult packed into one uint8 buffer: each field's bytes
    at `layout`'s offset, the 4-byte fields first so that every offset is
    aligned for its type."""

    buf: torch.Tensor  # (nbytes,) uint8, on the card or on the host
    layout: tuple  # per field, in field order: (dtype, shape, offset, nbytes)

    def unpack(self) -> WindowDecodeResult:
        """The fields as views of buf."""
        return WindowDecodeResult(*(self.buf[o:o + n].view(dt).view(shape)
                                    for dt, shape, o, n in self.layout))

    def numpy(self) -> WindowDecodeResult:
        """The fields as numpy arrays, fetched in one copy (which waits for
        the device)."""
        host = PackedResult(self.buf.cpu(), self.layout).unpack()
        return WindowDecodeResult(*(x.numpy() for x in host))


def result_layout(res: WindowDecodeResult) -> tuple:
    """The PackedResult layout of results shaped as res."""
    sizes = [(x.dtype, tuple(x.shape), x.numel() * x.element_size()) for x in res]
    offsets = [0] * len(sizes)
    off = 0
    for i in sorted(range(len(sizes)), key=lambda i: -res[i].element_size()):
        offsets[i] = off
        off += sizes[i][2]
    return tuple((dt, shape, o, n) for (dt, shape, n), o in zip(sizes, offsets))


def pack(res: WindowDecodeResult, layout: tuple) -> torch.Tensor:
    """res's fields in one new uint8 buffer, in layout's order (one cat)."""
    order = sorted(range(len(layout)), key=lambda i: layout[i][2])
    return torch.cat([res[i].contiguous().view(-1).view(torch.uint8) for i in order])


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    static_in: torch.Tensor
    packed: torch.Tensor  # the graph's static output buffer
    layout: tuple
    tally: dict  # {(wrapper, fast): launches} of one pass
    pool_bytes: int  # device memory reserved by its capture (its pool)
    lock: threading.Lock


class GraphedPipeline:
    """A DecodePipeline on a card, run through CUDA graphs (module
    docstring). Called as the pipeline is: raw windows (B, raw_len) on its
    device -> a WindowDecodeResult of device tensors."""

    def __init__(self, pipe: DecodePipeline):
        device = pipe.B.device
        if device.type != "cuda":
            raise ValueError(f"GraphedPipeline: CUDA graphs need a pipeline on a CUDA "
                             f"device, not {device} (run the pipeline itself on the CPU)")
        self.pipe = pipe
        self.device = device
        self._graphs: dict = {}

    def __call__(self, raw: torch.Tensor) -> WindowDecodeResult:
        return self.run(raw).unpack()

    @property
    def graphs(self) -> dict:
        """The captured graphs by (shape, dtype, stream handle)."""
        return dict(self._graphs)

    def run(self, raw: torch.Tensor, host: bool = False,
            span=contextlib.nullcontext) -> PackedResult:
        """One pass over raw on the current stream: the packed results, copied
        on this stream to a new device buffer, or with host to pinned host
        memory (ready once the stream has been synchronized). raw on the host
        (pinned) is copied to the device without blocking, inside the span
        that span(name) opens around the pass."""
        on_host = raw.device.type == "cpu"
        if not on_host and raw.device != self.device:
            raise ValueError(f"GraphedPipeline: raw is on {raw.device}, the pipeline "
                             f"on {self.device}")
        stream = torch.cuda.current_stream(self.device)
        key = (tuple(raw.shape), raw.dtype, stream.cuda_stream)
        g, name = graph_for(self._graphs, key)
        with span(name):
            if on_host:
                raw = raw.to(self.device, non_blocking=True)
            if g is None:
                with _capture_lock:
                    g = self._graphs.get(key)
                    if g is None:
                        return self._capture(key, raw, stream, host)
            with g.lock:
                g.static_in.copy_(raw)
                g.graph.replay()
                kernels.add_launches(g.tally)
                return _copy_out(g.packed, g.layout, host)

    def _capture(self, key, raw: torch.Tensor, stream, host: bool) -> PackedResult:
        """The first call of a key, under _capture_lock."""
        kernels.library()
        res = self.pipe(raw)  # the eager pass: warms up, and is this call's result
        layout = result_layout(res)
        first = pack(res, layout)
        first = _copy_out(first, layout, True) if host else PackedResult(first, layout)
        static_in = raw.clone()
        cap = (torch.cuda.Stream(self.device)
               if stream == torch.cuda.default_stream(self.device) else stream)
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(self.device)
        with kernels.recording() as tally, torch.cuda.graph(
                graph, stream=cap, capture_error_mode="thread_local"):
            packed = pack(self.pipe(static_in), layout)
        self._graphs[key] = _Graph(graph, static_in, packed, layout, tally,
                                   torch.cuda.memory_reserved(self.device) - before,
                                   threading.Lock())
        return first


def graph_for(graphs: dict, key) -> tuple:
    """(key's graph, "launch") where graphs holds it, else (None,
    "graph_capture"): the pass captures it (or replays under that name where
    another thread captured it meanwhile)."""
    g = graphs.get(key)
    return g, ("graph_capture" if g is None else "launch")


def _copy_out(buf: torch.Tensor, layout: tuple, host: bool) -> PackedResult:
    if not host:
        return PackedResult(buf.clone(), layout)
    out = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=True)
    out.copy_(buf, non_blocking=True)
    return PackedResult(out, layout)
