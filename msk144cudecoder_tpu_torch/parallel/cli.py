"""Distributed decode runner: `python -m msk144cudecoder_tpu_torch.parallel`.

Port of msk144cudecoder_tpu/parallel/cli.py. The stream CLI decodes on one
device; this runner decodes a capture file over a (time, freq) mesh of
devices in one or several processes. Every process runs the same command
on the same capture:

  python -m msk144cudecoder_tpu_torch.parallel --input capture.raw \\
      --coordinator host0:1234 --num-processes 2 --process-id 0 &
  python -m msk144cudecoder_tpu_torch.parallel --input capture.raw \\
      --coordinator host0:1234 --num-processes 2 --process-id 1

How the work is laid out (parallel/multihost.py):

  * the mesh's time rows are split over the processes (each decodes its own
    stream segment), and each row's frequency shards run on the process's
    own devices (each shard keeps its own top K survivors);
  * each process reads only its own byte range of the input (window range
    plus a one-window overlap halo at the segment tail);
  * decode steps run in lockstep (the same file length everywhere gives the
    same step count; short rows zero-pad), and each process prints only its
    own windows' decode lines, so the per-process outputs concatenated in
    process order give the single-stream order.

With one process this frequency-shards a capture over the local devices
(`--mesh-time 1`); `--device=cpu` runs every shard's plain torch path.
"""

from __future__ import annotations

import os
import socket
import sys
from typing import List, Optional

import numpy as np

from .. import constants as C


def build_parser():
    from ..cli import build_parser as base_parser

    p = base_parser()
    p.prog = "msk144torchdecoder-parallel"
    p.description = ("Distributed MSK144 decode of a capture file over a "
                     "(time, freq) mesh of torch devices in one or several "
                     "processes. Run the same command on every process.")
    p.add_argument("--input", required=True,
                   help="capture file (16-bit mono audio or 2x8-bit IQ, "
                        "per --read-mode); every process reads its own "
                        "segment of the same file")
    p.add_argument("--coordinator", default=None,
                   help="coordinator host:port of the gloo process group "
                        "(or MSK144_COORDINATOR)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--mesh-time", type=int, default=None,
                   help="time-axis size (default: number of processes)")
    p.add_argument("--mesh-freq", type=int, default=None,
                   help="freq-axis size (default: this process's devices "
                        "per owned time row; cpu or cuda:N repeat)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    from ..cli import config_from_args, resolve_device
    from . import multihost

    cfg = config_from_args(args)
    device = resolve_device(args.device)
    if (args.coordinator or args.num_processes is not None
            or os.environ.get("MSK144_COORDINATOR")
            or os.environ.get("MSK144_NUM_PROCESSES")):
        multihost.init_distributed(args.coordinator, args.num_processes, args.process_id)
    try:
        return run(args, cfg, device)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def run(args, cfg, device) -> int:
    import torch.distributed as dist

    from ..cli import print_banner
    from ..runtime import StreamDecoder
    from . import multihost
    from .sharding import MeshDecoder

    pid, nproc = multihost.process_index(), multihost.process_count()
    mesh = multihost.global_mesh(args.mesh_time, args.mesh_freq, device)
    n_time, n_freq = mesh.shape
    # distinct devices of the job: this process's, and every other's
    mine = sorted({(socket.gethostname(), str(d)) for d in mesh.flat})
    every = [mine]
    if dist.is_initialized():
        every = [None] * nproc
        dist.all_gather_object(every, mine)
    if pid == 0:
        print_banner(cfg, device)
        print(f"Mesh: {n_time} (time) x {n_freq} (freq) over {nproc} "
              f"process(es), {len({d for ds in every for d in ds})} device(s)",
              file=sys.stderr)

    if n_time % nproc:
        print(f"mesh time axis ({n_time}) must be a multiple of the "
              f"process count ({nproc})", file=sys.stderr)
        return 1

    per = 2 if cfg.read_mode == 2 else 1
    itemsize = 1 if cfg.read_mode == 2 else 2
    dtype = np.int8 if cfg.read_mode == 2 else np.int16

    total_samples = os.path.getsize(args.input) // itemsize
    total_windows = (total_samples - C.WINDOW_LEN * per) // (C.HOP_LEN * per) + 1
    if total_windows < 1:
        if pid == 0:
            print("Input shorter than one window", file=sys.stderr)
        return 1

    # Each time row of the mesh owns a contiguous window range of the
    # capture; a process owns n_time / nproc consecutive rows and reads only
    # those rows' sample segments (window range + one-window halo). One
    # StreamDecoder per owned row keeps the SNR EMA and the dedup scope
    # local to that row's contiguous stream segment; it only post-processes
    # (the MeshDecoder runs the device work), so it builds no pipeline.
    tpp = n_time // nproc  # time rows per process
    my_rows = list(range(pid * tpp, (pid + 1) * tpp))
    md = MeshDecoder(cfg, mesh[my_rows])
    segs, decs, n_locals = [], [], []
    with open(args.input, "rb") as f:
        for t in my_rows:
            wlo, whi = multihost.host_window_range(total_windows, n_time, t)
            slo, shi = multihost.host_sample_range(total_windows, n_time, t, cfg.read_mode)
            f.seek(slo * itemsize)
            segs.append(np.frombuffer(f.read((shi - slo) * itemsize), dtype))
            decs.append(StreamDecoder(cfg, device, survivor_capacity=cfg.max_survivors * n_freq,
                                      freqs=md.freqs))
            n_locals.append(whi - wlo)

    # lockstep steps: every time row contributes `wb` of its own windows
    # per step, short rows zero-padded
    wb = max(1, cfg.window_batch)
    per_row_max = -(-total_windows // n_time)  # longest row's window count
    n_steps = -(-per_row_max // wb)
    raw_len = C.WINDOW_LEN * per
    for step in range(n_steps):
        rows, valids = [], []
        for seg, n_local in zip(segs, n_locals):
            valid = 0
            for i in range(step * wb, (step + 1) * wb):
                if i < n_local:
                    o = i * C.HOP_LEN * per
                    rows.append(seg[o:o + raw_len])
                    valid += 1
                else:
                    rows.append(np.zeros(raw_len, dtype))
            valids.append(valid)
        res = md.decode(np.stack(rows))
        for r, (dec, valid) in enumerate(zip(decs, valids)):
            batch_view = type(res)(*(x[r * wb:(r + 1) * wb] for x in res))
            for items in dec.postprocess_batch(batch_view, valid):
                for item in items:
                    print(item.format_line(), flush=True)
    if dist.is_initialized():
        dist.barrier()
    if pid == 0:
        print("Done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
