"""live: `StreamDecoder.decode_block(window)` on each window in stream
order, back to back: one live receiver's per-hop decode (submit, fetch,
post-process). Each call is timed by one host-clock pair around it."""

from __future__ import annotations

import contextlib
import itertools
import time

import numpy as np


def warm(decoder, windows, traffic: dict, n: int, sink) -> None:
    """decode_block on the stream's first n windows, untimed."""
    with contextlib.redirect_stdout(sink):
        for w in itertools.islice(windows, n):
            decoder.decode_block(w)


def run(decoder, windows, traffic: dict, clock, sink):
    """decode_block on each window of the window; its latencies in ms."""
    from bench_torch.common.drivers import Window

    lat = []
    clk = time.perf_counter
    with contextlib.redirect_stdout(sink):
        for w in clock.windows(windows):
            t = clk()
            decoder.decode_block(w)
            lat.append(clk() - t)
    wall = clk() - clock.t0
    return Window(clock.n, wall, np.array(lat, dtype=np.float64) * 1e3, clock.framing_s,
                  clock.per_second)
