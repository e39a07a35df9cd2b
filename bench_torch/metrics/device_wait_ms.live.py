"""device_wait_ms.live: the program's `device_wait_transfer` span in
StreamDecoder.collect (the wait for the replayed pass and the copy of its
packed result to the host), summed over the window, per window. Live driver
only."""


def read(run):
    if run.cell.traffic["driver"] != "live":
        return None
    return run.span_ms_per_window("device_wait_transfer")
