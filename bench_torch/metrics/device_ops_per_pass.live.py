"""device_ops_per_pass.live: device operations (kernels, copies, memsets)
per replayed pass, from the profiler's trace: their count in the traced
slice over the decode_block calls that began in it."""


def read(run):
    s = run.slice
    if run.cell.traffic["driver"] != "live" or s is None or not s.done or not s.passes or not s.device:
        return None
    return len(s.device) / s.passes
