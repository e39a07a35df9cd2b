"""Frequency- and time-sharded decode over a (time, freq) grid of devices.

Port of msk144cudecoder_tpu/parallel/sharding.py. Axes:
  "time"  data parallel over streaming windows: windows are independent
          after the host's 50%-overlap framing, so this axis needs no
          communication.
  "freq"  the reference's grid over frequency channels becomes a split of
          the (padded) frequency grid: each shard holds only its slice of
          the frequency tables, demodulates and BP-decodes its own top K
          survivors, and the survivor lists concatenate on output.

The JAX package runs the shards as one jitted shard_map program; here each
(time, freq) shard is a DecodePipeline on its own device, which on a card
replays its own CUDA graph there (ops/graphs.py; on the CPU it runs
eagerly). `decode` launches every shard before it fetches any, so shards on
different cards overlap, then assembles the result on the host as
shard_map's out_specs do: candidate indices shifted by the shard's offset,
num_survivors summed and shard_survivors the maximum over the freq axis,
the K axis concatenated in shard order. A device may appear in several cells of the grid, so that the
CPU or one card can hold several shards.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import constants as C
from ..config import DecoderConfig
from ..ops import graphs, kernels, pipeline
from ..ops.tables import padded_freqs
from ..runtime.decoder import to_host


def make_mesh(n_time: int = 1, n_freq: Optional[int] = None,
              devices: Optional[Sequence] = None) -> np.ndarray:
    """An (n_time, n_freq) object array of torch devices. Default devices:
    every visible CUDA device (without a card this raises: a CPU mesh is
    asked for by listing "cpu"); default n_freq: all of them on the freq
    axis. A device may be listed more than once."""
    if devices is None:
        kernels.resolve_device("cuda")  # raises without a card
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [kernels.resolve_device(d) for d in devices]
    if n_freq is None:
        n_freq = len(devices) // n_time
    if n_time * n_freq != len(devices) or n_time < 1 or n_freq < 1:
        raise ValueError(f"mesh {n_time}x{n_freq} != {len(devices)} devices")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return grid.reshape(n_time, n_freq)


def stream_to_windows(samples: np.ndarray, read_mode: int = 1) -> np.ndarray:
    """Host-side overlap-save framing of a contiguous stream segment into the
    (B, window) batch the sharded decoder consumes: windows advance by 50%
    (HOP_LEN), as the streaming loop slides."""
    per = 2 if read_mode == 2 else 1
    n_full, n_hop = C.WINDOW_LEN * per, C.HOP_LEN * per
    n_win = (len(samples) - n_full) // n_hop + 1
    if n_win < 1:
        raise ValueError("stream segment shorter than one window")
    idx = np.arange(n_win)[:, None] * n_hop + np.arange(n_full)[None, :]
    return np.ascontiguousarray(samples[idx])


class MeshDecoder:
    """Sharded decode of a window batch over a (time, freq) device grid.

    One DecodePipeline per (device, freq shard), holding that shard's slice
    of the padded grid's tables and its channel mask (the pad channels past
    the right boundary never reach a result), run through its graphs on a
    card."""

    def __init__(self, cfg: DecoderConfig, mesh: np.ndarray):
        self.cfg = cfg
        self.mesh = mesh
        self.n_time, self.n_freq = mesh.shape
        self.freqs = padded_freqs(cfg.freqs, self.n_freq)
        self.local_f = len(self.freqs) // self.n_freq
        self.local_cand = self.local_f * cfg.scan_depth * cfg.candidates_per_pattern
        n_real = cfg.num_freqs  # grid channels beyond this are sharding pad
        built = {}
        self._runs = np.empty(mesh.shape, dtype=object)  # a pass of each shard
        for (t, j), dev in np.ndenumerate(mesh):
            key = (str(dev), j)
            if key not in built:
                lo = j * self.local_f
                chan_valid = np.arange(lo, lo + self.local_f) < n_real
                pipe = pipeline.DecodePipeline(
                    cfg, freqs=self.freqs[lo:lo + self.local_f],
                    chan_valid=chan_valid).to(dev)
                built[key] = graphs.GraphedPipeline(pipe).run if dev.type == "cuda" else pipe
            self._runs[t, j] = built[key]
        for dev in {d for d in mesh.flat if d.type == "cuda"}:
            torch.cuda.synchronize(dev)

    def decode(self, raw_windows) -> pipeline.WindowDecodeResult:
        """raw_windows (B, raw_len), B divisible by the time-axis size ->
        globally indexed results as numpy arrays: row block t of the batch
        is time row t's, and each row's survivor axis is the concatenation
        of the freq shards' top K (K * n_freq in all)."""
        raw = np.ascontiguousarray(raw_windows)
        if raw.shape[0] % self.n_time:
            raise ValueError(f"batch of {raw.shape[0]} windows does not split over "
                             f"{self.n_time} time rows")
        rows = raw.shape[0] // self.n_time
        launched = [[self._runs[t, j](torch.from_numpy(raw[t * rows:(t + 1) * rows])
                                      .to(self.mesh[t, j]))
                     for j in range(self.n_freq)] for t in range(self.n_time)]
        fetched = [[to_host(r) for r in row] for row in launched]
        return pipeline.WindowDecodeResult(*(
            np.concatenate([self._assemble(row, field) for row in fetched])
            for field in pipeline.WindowDecodeResult._fields))

    def _assemble(self, shards, field: str) -> np.ndarray:
        """One time row's `field` from its freq shards' results."""
        leaves = [getattr(r, field) for r in shards]
        if field == "cand_index":
            return np.concatenate([x + np.int32(j * self.local_cand)
                                   for j, x in enumerate(leaves)], axis=1)
        if field == "num_survivors":
            return np.sum(leaves, axis=0, dtype=np.int32)
        if field == "shard_survivors":
            return np.max(leaves, axis=0)
        if field == "block_power":
            return leaves[0]  # every shard sees the same windows
        return np.concatenate(leaves, axis=1)

    def unpack_candidate_index(self, flat_idx: int) -> tuple[int, int, int]:
        """Global flat candidate index -> (freq_idx, pattern_idx, cand_num)."""
        return pipeline.unpack_candidate_index(self.cfg, flat_idx)
