"""device_ms_per_pass.live: the card's busy time per replayed pass (one
decode_block's CUDA graph): the union of the device operations' intervals
in the traced slice over the calls that began in it."""


def read(run):
    s = run.slice
    if run.cell.traffic["driver"] != "live" or s is None or not s.done or not s.passes or not s.device:
        return None
    return s.busy_s() * 1e3 / s.passes
