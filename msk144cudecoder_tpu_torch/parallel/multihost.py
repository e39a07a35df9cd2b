"""Multi-process decode: torch.distributed for the job, host-local streams.

Port of msk144cudecoder_tpu/parallel/multihost.py. Every process runs the
same command on the same capture:

  * `init_distributed()` joins the job (coordinator address, process count
    and rank from the arguments or the MSK144_* environment variables);
  * the (time, freq) mesh spans the job: time rows across processes (each
    process decodes its own stream segment), frequency shards over the
    process's own devices (`global_mesh`);
  * each process frames its own windows from its own byte range of the
    capture (the window range plus a one-window overlap halo at the segment
    tail, `host_sample_range`), and prints only its own windows' messages.

No decode data moves between processes: a process owns whole time rows,
and every freq shard of a row is one of its own devices. The process group
(gloo) carries the rank, the world size and the closing barrier; gloo also
lets two processes share one card, which NCCL refuses.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import constants as C
from ..ops import kernels
from .sharding import make_mesh


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Join the job's gloo process group at tcp://coordinator_address. Each
    argument falls back to MSK144_COORDINATOR, MSK144_NUM_PROCESSES and
    MSK144_PROCESS_ID; all three are required."""
    coord = coordinator_address or os.environ.get("MSK144_COORDINATOR")
    n = num_processes if num_processes is not None else os.environ.get("MSK144_NUM_PROCESSES")
    pid = process_id if process_id is not None else os.environ.get("MSK144_PROCESS_ID")
    if coord is None or n is None or pid is None:
        raise ValueError("a multi-process run needs the coordinator host:port, the "
                         "process count and this process's id (arguments or "
                         "MSK144_COORDINATOR / MSK144_NUM_PROCESSES / MSK144_PROCESS_ID)")
    dist.init_process_group("gloo", init_method=f"tcp://{coord}",
                            world_size=int(n), rank=int(pid))


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_devices(device=None) -> list[torch.device]:
    """This process's devices: every visible CUDA device for None or a bare
    "cuda", the one device for "cuda:N" or "cpu". Without a card only "cpu"
    gives a device; anything else raises."""
    dev = kernels.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def global_mesh(n_time: Optional[int] = None, n_freq: Optional[int] = None,
                device=None) -> np.ndarray:
    """The job's (n_time, n_freq) mesh as this process addresses it: every
    cell holds one of this process's devices (`local_devices(device)`,
    taken in turn, so a device repeats when the cells outnumber them), and
    the process decodes only its own time rows. Default: time = number of
    processes, freq = this process's devices per owned row."""
    n_proc = process_count()
    if n_time is None:
        n_time = n_proc
    devs = local_devices(device)
    if n_freq is None:
        n_freq = max(1, len(devs) // max(1, n_time // n_proc))
    return make_mesh(n_time, n_freq, [devs[i % len(devs)] for i in range(n_time * n_freq)])


def host_window_range(total_windows: int, n_hosts: int, host: int) -> tuple[int, int]:
    """Contiguous [lo, hi) window indices owned by `host` (balanced split)."""
    per = -(-total_windows // n_hosts)
    lo = min(host * per, total_windows)
    return lo, min(lo + per, total_windows)


def host_sample_range(total_windows: int, n_hosts: int, host: int,
                      read_mode: int = 1) -> tuple[int, int]:
    """Sample [lo, hi) of the stream this host must ingest to frame its
    windows, including the half-window overlap halo at the segment tail."""
    per = 2 if read_mode == 2 else 1
    wlo, whi = host_window_range(total_windows, n_hosts, host)
    lo = wlo * C.HOP_LEN * per
    hi = (whi - 1) * C.HOP_LEN * per + C.WINDOW_LEN * per if whi > wlo else lo
    return lo, hi
