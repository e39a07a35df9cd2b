"""throughput: the CLI's recording mode, `cli.decode_throughput(decoder,
windows, window_batch, pipeline_depth)`, with the traffic file's batch and
depth. The window runs from the first window handed to the CLI loop to the
loop's return; the decode lines go to a sink the harness keeps."""

from __future__ import annotations

import contextlib
import itertools
import time


def warm(decoder, windows, traffic: dict, n: int, sink) -> None:
    """The CLI loop over the stream's first n windows, untimed."""
    from msk144cudecoder_tpu_torch import cli

    with contextlib.redirect_stdout(sink):
        cli.decode_throughput(decoder, itertools.islice(windows, n), traffic["window_batch"],
                              traffic["pipeline_depth"])


def run(decoder, windows, traffic: dict, clock, sink):
    """The CLI loop over the window."""
    from msk144cudecoder_tpu_torch import cli

    from bench_torch.common.drivers import Window

    with contextlib.redirect_stdout(sink):
        cli.decode_throughput(decoder, clock.windows(windows), traffic["window_batch"],
                              traffic["pipeline_depth"])
    wall = time.perf_counter() - clock.t0
    return Window(clock.n, wall, None, clock.framing_s, clock.per_second)
