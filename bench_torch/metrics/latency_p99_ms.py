"""latency_p99_ms: the 99th percentile of decode_block's latency over every
window of the window (thousands of samples, so tens or hundreds beyond it),
read as latency_p50_ms is. Live driver only."""

import numpy as np


def read(run):
    lat = run.window.latencies_ms
    if lat is None or len(lat) < 1000:
        return None
    return float(np.percentile(lat, 99))
