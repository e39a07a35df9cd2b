"""latency_p50_ms: the median of decode_block's latency over every window
of the window, each call timed by one host-clock pair around it (submit,
the device pass, the fetch and post-processing). Live driver only."""

import numpy as np


def read(run):
    lat = run.window.latencies_ms
    if lat is None or not len(lat):
        return None
    return float(np.percentile(lat, 50))
