"""device_idle.recording: the share of the traced slice in which no operation ran
on the card, in percent: 100 x (1 - the union of every kernel, copy and
memset interval of the profiler's trace over the slice's length). The union,
not the sum: operations on several streams overlap."""

DRIVER = "throughput"


def read(run):
    s = run.slice
    if run.cell.traffic["driver"] != DRIVER or s is None or not s.done or s.window_s <= 0 or not s.device:
        return None
    return 100.0 * (1.0 - s.busy_s() / s.window_s)
