"""StreamDecoder: the host loop around the decode pipeline.

Port of msk144cudecoder_tpu/runtime/decoder.py: run the device pipeline on
raw windows, then on the host unpack each decoded 77-bit payload to text
(with a bounded content-keyed memo cache), track SNR, and deduplicate
through the ResultFilter. `submit()` enqueues the device work (PyTorch's
CUDA calls return before the device finishes) and `collect()` copies the
oldest result to the host and post-processes it.
"""

from __future__ import annotations

import sys
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import constants as C
from ..config import DecoderConfig
from ..ops import pipeline
from ..protocol import msg77
from .metrics import ScopedMetric
from .result_filter import ResultFilter, ResultItem
from .snr import SNRTracker

#: Cap on the content-keyed unpack memo (FIFO eviction): a stream decoder
#: runs indefinitely, and a cap keeps the worst case bounded.
DECODE_CACHE_MAX = 4096


class StreamDecoder:
    def __init__(self, cfg: DecoderConfig, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # the port computes in float32: no TF32 in any cuBLAS/cuDNN call
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.pipeline = pipeline.DecodePipeline(cfg).to(self.device)
        # LDPC rows decoded per window: the bound the overflow warning cites
        # (K on one device; a frequency-sharded run would decode K per shard)
        self.survivor_capacity = cfg.max_survivors
        self.snr_tracker = SNRTracker()
        self.result_filter = ResultFilter()
        self.hashes = msg77.CallsignHashTable()
        self._decode_cache: Dict[bytes, Tuple[bool, str]] = {}
        self._freqs = cfg.freqs
        self._pending: deque = deque()  # in-flight WindowDecodeResults (FIFO)
        # survivor-overflow warning aggregation (see _warn_overflow): global
        # and per-shard overflows tracked separately so the rate-limited
        # aggregate cites the right bound
        self._ovf_count = 0
        self._ovf_max_global = 0
        self._ovf_max_shard = 0
        self._ovf_window = 0

    # -- device side ------------------------------------------------------

    def _run(self, raw_batch) -> pipeline.WindowDecodeResult:
        raw = torch.from_numpy(np.ascontiguousarray(raw_batch)).to(self.device)
        return self.pipeline(raw)

    def submit(self, raw_window: np.ndarray) -> None:
        """Enqueue the device pipeline on one raw window. Several windows
        may be in flight; collect() drains them in order."""
        self._pending.append(self._run(np.asarray(raw_window)[None, :]))

    @property
    def in_flight(self) -> int:
        return len(self._pending)

    def collect(self) -> List[ResultItem]:
        """Fetch the oldest in-flight window, post-process, return its
        deduped results."""
        if not self._pending:
            raise RuntimeError("collect() without a submitted window")
        with ScopedMetric("device_wait_transfer"):
            res = to_host(self._pending.popleft())
        with ScopedMetric("postprocess"):
            return self._postprocess_one(res, 0)

    def decode_block(self, raw_window: np.ndarray) -> List[ResultItem]:
        """Synchronous submit+collect of one window."""
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
        host post-processing."""
        return to_host(self._run(np.asarray(raw_batch)))

    def postprocess_batch(self, res: pipeline.WindowDecodeResult,
                          n_valid: int) -> List[List[ResultItem]]:
        """Sequential host post-processing of a fetched batch result, in
        stream order. Call from one thread, batches in stream order."""
        return [self._postprocess_one(res, b) for b in range(n_valid)]

    # -- host side --------------------------------------------------------

    def _unpack_cached(self, bits77: np.ndarray) -> Tuple[bool, str]:
        key = np.packbits(bits77).tobytes()
        hit = self._decode_cache.get(key)
        if hit is not None:
            return hit
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
        local K. The xb prefilter is always on in this port, so both counts
        are lower bounds (nbadsync exists only for the demodulated,
        prefiltered candidates) and the warning says "at least"."""
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
            # cite the bound that was exceeded: the global capacity first,
            # then the per-shard one
            g = n_surv if n_surv > 0 else self._ovf_max_global
            if g > 0:
                head = (f"at least {g} sync survivors exceed the LDPC batch "
                        f"(max_survivors={self.survivor_capacity})")
            else:
                s = shard_surv if shard_over else self._ovf_max_shard
                head = (f"at least {s} sync survivors in one frequency "
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
        self._warn_overflow(n_surv if n_surv > self.survivor_capacity else 0,
                            shard_surv)
        self.snr_tracker.process_powers(res.block_power[b])
        self.result_filter.block_begin()
        found = np.asarray(res.found[b])
        with ScopedMetric("unpack77"):
            for k in np.nonzero(found)[0]:
                bits77 = pipeline.unpack_message_bits(res.message_bits[b][k])
                ok, text = self._unpack_cached(bits77)
                if not ok:
                    continue
                fi, pi, _ = pipeline.unpack_candidate_index(
                    self.cfg, int(res.cand_index[b][k]))
                self.result_filter.put_message(
                    snr=self.snr_tracker.snr_i,
                    f0=float(self._freqs[fi]),
                    num_avg=int(C.PATTERN_NUM_AVG[pi]),
                    nbadsync=int(res.nbadsync[b][k]),
                    pattern_idx=pi,
                    message=text,
                )
        with ScopedMetric("result_filter"):
            self.result_filter.block_end()
            return self.result_filter.block_result()


def to_host(res: pipeline.WindowDecodeResult) -> pipeline.WindowDecodeResult:
    """Every leaf of a WindowDecodeResult as a numpy array (one .cpu() per
    leaf; the first waits for the device)."""
    return type(res)(*(x.cpu().numpy() for x in res))
