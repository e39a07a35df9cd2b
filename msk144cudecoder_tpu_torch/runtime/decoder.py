"""StreamDecoder: the host loop around the decode pipeline.

Port of msk144cudecoder_tpu/runtime/decoder.py: run the device pipeline on
raw windows, then on the host group each window's decoded rows by their
77-bit payload, unpack each payload to text (through a bounded memo keyed on
its packed bytes), track SNR, and deduplicate through the ResultFilter.
`submit()` enqueues the device work (PyTorch's CUDA calls return before the
device finishes) and `collect()` copies the oldest result to the host and
post-processes it.

On a card every pass (`submit`, `decode_block`, `decode_many`,
`decode_to_host`) replays a CUDA graph of the pipeline (ops/graphs.py, the
counterpart of the JAX package's jax.jit), one per batch shape and CUDA
stream, captured at its first pass; on the CPU the pipeline runs eagerly.
`decode_to_host` may be called from several threads at once (the CLI's
throughput mode): on a card each call runs on its thread's own CUDA stream,
with its own graph, from a pinned host copy of the batch to a pinned host
copy of the results, and returns after that stream's synchronize.
Post-processing keeps stream state (SNR, dedup) and runs on one thread, in
stream order. The configuration's precision (DecoderConfig.fast_math)
reaches the kernels, or their plain versions, through the pipeline.
"""

from __future__ import annotations

import itertools
import sys
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import constants as C
from ..config import DecoderConfig
from ..ops import graphs, kernels, pipeline
from ..protocol import msg77
from . import metrics
from .metrics import ScopedMetric
from .result_filter import ResultFilter, ResultItem
from .snr import SNRTracker

#: Cap on the content-keyed unpack memo (FIFO eviction): a stream decoder
#: runs indefinitely, and a cap keeps the worst case bounded.
DECODE_CACHE_MAX = 4096

_NUM_AVG = C.PATTERN_NUM_AVG.tolist()  # per pattern, as Python ints


class StreamDecoder:
    def __init__(self, cfg: DecoderConfig, device=None,
                 survivor_capacity: Optional[int] = None,
                 freqs: Optional[np.ndarray] = None):
        """device: the card by default; without one this raises unless the
        caller passes "cpu". survivor_capacity: LDPC rows decoded per
        window, the bound the overflow warning cites: cfg.max_survivors on
        one device, K * n_freq on a mesh (each frequency shard decodes its
        own top K). freqs: the
        grid that candidate indices refer to, when it is not cfg.freqs (a
        mesh pads the grid; real channels keep their indices). The device
        pipeline is built at the first device call, so a decoder that only
        post-processes (the parallel runner's) never builds one."""
        self.cfg = cfg
        self.device = kernels.resolve_device(device)
        if self.device.type == "cuda":
            # the port computes in float32: no TF32 in any cuBLAS/cuDNN call
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self._pipeline: Optional[pipeline.DecodePipeline] = None
        self._graphed: Optional[graphs.GraphedPipeline] = None  # on a card
        self._pipeline_lock = threading.Lock()
        self._streams = threading.local()  # per decode_to_host thread: its CUDA stream
        self.survivor_capacity = (cfg.max_survivors if survivor_capacity is None
                                  else survivor_capacity)
        # with the xb prefilter on, survivor counts are lower bounds: only the
        # prefiltered candidates are demodulated, and nbadsync exists only
        # after the demod. With it off (the full demod) they are exact. On a
        # mesh the prefilter resolves per shard, against the local candidate
        # count over the padded grid.
        n_shards = max(1, self.survivor_capacity // max(cfg.max_survivors, 1))
        grid_f = len(cfg.freqs) if freqs is None else len(freqs)
        local_nc = -(-grid_f // n_shards) * cfg.scan_depth * cfg.candidates_per_pattern
        self._count_is_lower_bound = pipeline.resolve_prefilter(cfg, local_nc) > 0
        self.snr_tracker = SNRTracker()
        self.result_filter = ResultFilter()
        self.hashes = msg77.CallsignHashTable()
        self._decode_cache: Dict[bytes, Tuple[bool, str]] = {}
        self._memo_hits = 0  # of _decode_cache, over the decoder's life
        self._freqs = cfg.freqs if freqs is None else freqs
        self._pending: deque = deque()  # in-flight results of _run (FIFO)
        self._blocks = 0  # decode_block calls: the request id of their spans
        # survivor-overflow warning aggregation (see _warn_overflow): global
        # and per-shard overflows tracked separately so the rate-limited
        # aggregate cites the right bound
        self._ovf_count = 0
        self._ovf_max_global = 0
        self._ovf_max_shard = 0
        self._ovf_window = 0

    # -- device side ------------------------------------------------------

    @property
    def pipeline(self) -> pipeline.DecodePipeline:
        """The device pipeline, built once, by whichever thread asks first.
        On a card the buffers are written on the default stream, so the
        build waits for them before any worker stream reads them."""
        if self._pipeline is None:
            with self._pipeline_lock:
                if self._pipeline is None:
                    pipe = pipeline.DecodePipeline(self.cfg).to(self.device)
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                        self._graphed = graphs.GraphedPipeline(pipe)
                    self._pipeline = pipe
        return self._pipeline

    @property
    def graphed(self) -> graphs.GraphedPipeline:
        """The pipeline's CUDA graphs (a card only: on the CPU this raises)."""
        pipe = self.pipeline  # built at first use, with its graphs on a card
        if self._graphed is None:
            raise RuntimeError(f"StreamDecoder on {pipe.B.device} runs eagerly: no CUDA graphs")
        return self._graphed

    def _run(self, raw_batch, stream=None):
        """One pass: on the CPU the eager WindowDecodeResult (spans `h2d`,
        `launch`), on a card a graph's PackedResult. Without stream (submit)
        a pageable copy under `h2d`, the pass on the current stream, the
        result on the card; with stream (decode_to_host) pinned staging under
        `pin`, the pass on stream from a copy enqueued in its span, the
        result in pinned host memory. GraphedPipeline.run names the pass's
        span: `launch`, or `graph_capture` where it captures."""
        host = torch.from_numpy(np.ascontiguousarray(raw_batch))
        if stream is None:
            with ScopedMetric("h2d"):
                raw = host.to(self.device)
            if self.device.type != "cuda":
                with ScopedMetric("launch"):
                    return self.pipeline(raw)
            return self.graphed.run(raw, span=ScopedMetric)
        graphed = self.graphed
        with ScopedMetric("pin"):
            host = host.pin_memory()
        with torch.cuda.stream(stream):
            return graphed.run(host, host=True, span=ScopedMetric)

    def submit(self, raw_window: np.ndarray) -> None:
        """Enqueue the device pipeline on one raw window. Several windows
        may be in flight; collect() drains them in order."""
        metrics.refresh()
        self._pending.append(self._run(np.asarray(raw_window)[None, :]))

    @property
    def in_flight(self) -> int:
        return len(self._pending)

    def collect(self) -> List[ResultItem]:
        """Fetch the oldest in-flight window, post-process, return its
        deduped results."""
        if not self._pending:
            raise RuntimeError("collect() without a submitted window")
        metrics.refresh()
        with ScopedMetric("device_wait_transfer"):
            res = to_host(self._pending.popleft())
        with ScopedMetric("postprocess"):
            return self._postprocess_one(res, 0)

    def decode_block(self, raw_window: np.ndarray) -> List[ResultItem]:
        """Synchronous submit+collect of one window; the spans under it
        carry the call's number as their request id."""
        metrics.refresh()
        self._blocks += 1
        with metrics.request(self._blocks):
            self.submit(raw_window)
            return self.collect()

    def decode_many(self, raw_batch: np.ndarray,
                    n_valid: Optional[int] = None) -> List[List[ResultItem]]:
        """Decode a (B, raw_len) batch in one device call; post-process each
        window in stream order (SNR EMA and dedup scopes stay sequential).
        n_valid < B ignores trailing pad windows (batch-tail flush)."""
        res = self.decode_to_host(raw_batch)
        n = len(raw_batch) if n_valid is None else n_valid
        return self.postprocess_batch(res, n)

    def decode_to_host(self, raw_batch: np.ndarray) -> pipeline.WindowDecodeResult:
        """Device decode of a (B, raw_len) batch and its result fetch, without
        host post-processing. Safe to call from several threads at once: on
        a card each thread decodes on its own CUDA stream (the kernels
        launch on the current stream), and the call returns once that
        stream has finished. Spans: `decode_to_host`, with children `pin`
        (the batch to pinned memory), `launch` or `graph_capture` (the copy
        to the card, the pass and its copy back, enqueued) and `sync` (the
        stream's synchronize)."""
        metrics.refresh()
        with ScopedMetric("decode_to_host"):
            if self.device.type != "cuda":
                return to_host(self._run(raw_batch))
            stream = getattr(self._streams, "stream", None)
            if stream is None:
                stream = self._streams.stream = torch.cuda.Stream(self.device)
            out = self._run(raw_batch, stream)
            with ScopedMetric("sync"):
                stream.synchronize()
            return out.numpy()

    def postprocess_batch(self, res: pipeline.WindowDecodeResult,
                          n_valid: int) -> List[List[ResultItem]]:
        """Sequential host post-processing of a fetched batch result, in
        stream order. Call from one thread, batches in stream order."""
        metrics.refresh()
        return [self._postprocess_one(res, b) for b in range(n_valid)]

    # -- host side --------------------------------------------------------

    def _lookup(self, key: bytes) -> Tuple[bool, str]:
        """(ok, text) of one payload, keyed by its packed bytes (np.packbits
        order, pad bits zero, as pipeline.pack_message_bits writes them);
        unpack77 on a miss only."""
        hit = self._decode_cache.get(key)
        if hit is not None:
            self._memo_hits += 1
            return hit
        bits77 = pipeline.unpack_message_bits(np.frombuffer(key, np.uint8))
        if msg77.plausible_message_type(bits77):
            out = msg77.unpack77(bits77, self.hashes)
        else:
            out = (False, "")
        if len(self._decode_cache) >= DECODE_CACHE_MAX:
            self._decode_cache.pop(next(iter(self._decode_cache)))
        self._decode_cache[key] = out
        return out

    #: windows between aggregated overflow warnings (the first overflow
    #: prints immediately; on a busy band every window can overflow)
    OVERFLOW_WARN_EVERY = 256

    def _warn_overflow(self, n_surv: int, shard_surv: int = 0) -> None:
        """Never silently truncate: the reference BP-decodes every
        under-threshold survivor; this decodes the best max_survivors by
        exact (nbadsync, xb) order and says so, immediately on the first
        occurrence and then as a rate-limited aggregate.

        Two triggers (either suffices): the global survivor count exceeding
        the total LDPC capacity, and any single frequency shard exceeding its
        local K. With the xb prefilter on both counts are lower bounds and
        the warning says "at least"; with it off they are exact."""
        self._ovf_window += 1
        shard_over = shard_surv > self.cfg.max_survivors
        if n_surv > 0 or shard_over:
            self._ovf_count += 1
            self._ovf_max_global = max(self._ovf_max_global, n_surv)
            if shard_over:
                self._ovf_max_shard = max(self._ovf_max_shard, shard_surv)
        if ((self._ovf_count == 1 and (n_surv > 0 or shard_over))
                or (self._ovf_window >= self.OVERFLOW_WARN_EVERY
                    and self._ovf_count)):
            mx = max(self._ovf_max_global, self._ovf_max_shard)
            agg = (f" ({self._ovf_count} of the last {self._ovf_window} "
                   f"windows overflowed; max {mx})"
                   if self._ovf_window > 1 else "")
            lb = "at least " if self._count_is_lower_bound else ""
            # cite the bound that was exceeded: the global capacity first,
            # then the per-shard one
            g = n_surv if n_surv > 0 else self._ovf_max_global
            if g > 0:
                head = (f"{lb}{g} sync survivors exceed the LDPC batch "
                        f"(max_survivors={self.survivor_capacity})")
            else:
                s = shard_surv if shard_over else self._ovf_max_shard
                head = (f"{lb}{s} sync survivors in one frequency "
                        f"shard exceed its local batch "
                        f"(max_survivors={self.cfg.max_survivors} per shard)")
            print(
                f"Warning: {head}; decoding the best survivors by "
                f"(nbadsync, xb).{agg}",
                file=sys.stderr,
            )
            if self._ovf_window >= self.OVERFLOW_WARN_EVERY:
                self._ovf_count = self._ovf_window = 0
                self._ovf_max_global = self._ovf_max_shard = 0

    def _postprocess_one(self, res, b: int) -> List[ResultItem]:
        """Host post-processing for window b of a batched result."""
        n_surv = int(res.num_survivors[b])
        shard_surv = int(res.shard_survivors[b])
        # rows under the threshold (exact on the full-demod path, a lower
        # bound behind the prefilter) and the most of them BP can take: the
        # rows it takes where every pattern's survivors fill its quota or
        # every pattern's fit in it, on one device; more where they do not,
        # or where a mesh's shards hold unequal counts
        metrics.count("grid_survivors", n_surv)
        metrics.count("survivors_decoded", min(n_surv, self.survivor_capacity))
        self._warn_overflow(n_surv if n_surv > self.survivor_capacity else 0,
                            shard_surv)
        self.snr_tracker.process_powers(res.block_power[b])
        self.result_filter.block_begin()
        rows = np.flatnonzero(np.asarray(res.found[b]))
        with ScopedMetric("unpack77"):
            if rows.size:
                self._put_messages(res, b, rows)
        with ScopedMetric("result_filter"):
            self.result_filter.block_end()
            return self.result_filter.block_result()

    def _put_messages(self, res, b: int, rows: np.ndarray) -> None:
        """One put_message per message text among window b's decoded rows,
        for the row the result filter keeps: least (num_avg, nbadsync), the
        earliest on a tie. Rows are grouped by their packed payload, in
        order of first row: one memo lookup per payload, so the misses
        unpack in the order a lookup per row would make them. The row
        fields leave numpy in one tolist each: a window has tens of rows,
        and each numpy call runs cold between framing and the device
        fetch, so one pass in Python over lists beats a chain of small
        array operations."""
        rows = rows.tolist()
        n = len(rows)
        bits = np.asarray(res.message_bits[b])
        width = bits.shape[-1]
        packed = bits.tobytes()
        keys = [packed[k * width:(k + 1) * width] for k in rows]
        ids: Dict[bytes, int] = {}
        group = [ids.setdefault(key, len(ids)) for key in keys]
        memo = self._decode_cache
        hits = self._memo_hits
        evict = len(memo) + sum(key not in memo for key in ids) - DECODE_CACHE_MAX
        if evict > 0 and (evict > len(memo)
                          or not ids.keys().isdisjoint(itertools.islice(memo, evict))):
            # a payload of this window may leave the FIFO before its last
            # row: look every row up, in row order, each row its own group
            group = range(n)
            looked = [self._lookup(key) for key in keys]
        else:
            looked = [self._lookup(key) for key in ids]
            self._memo_hits += n - len(ids)  # a payload's later rows
        metrics.count("unpack_lookups", n)  # every row looks its payload up
        metrics.count("memo_hits", self._memo_hits - hits)
        metrics.count("unpack_payloads", len(ids))
        cand = np.asarray(res.cand_index[b]).tolist()
        nbadsync = np.asarray(res.nbadsync[b]).tolist()
        per_f = self.cfg.scan_depth * self.cfg.candidates_per_pattern
        per_p = self.cfg.candidates_per_pattern
        best: Dict[str, tuple] = {}  # text -> ((num_avg, nbadsync), row)
        for (ok, text), k in zip((looked[g] for g in group), rows):
            if ok:
                rank = (_NUM_AVG[cand[k] % per_f // per_p], nbadsync[k])
                kept = best.get(text)
                if kept is None or rank < kept[0]:  # rows ascend: the earliest keeps a tie
                    best[text] = (rank, k)
        snr = self.snr_tracker.snr_i
        for text, ((num_avg, nbad), k) in best.items():
            fi, pi, _ = pipeline.unpack_candidate_index(self.cfg, cand[k])
            self.result_filter.put_message(
                snr=snr,
                f0=float(self._freqs[fi]),
                num_avg=num_avg,
                nbadsync=nbad,
                pattern_idx=pi,
                message=text,
            )

def to_host(res) -> pipeline.WindowDecodeResult:
    """Every leaf of a WindowDecodeResult as a numpy array (one .cpu() per
    leaf; the first waits for the device), or of a graph's PackedResult (one
    copy)."""
    if isinstance(res, graphs.PackedResult):
        return res.numpy()
    return type(res)(*(x.cpu().numpy() for x in res))
