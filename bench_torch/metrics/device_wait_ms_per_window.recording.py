"""device_wait_ms_per_window.recording: the program's `device_wait_transfer`
span in cli.decode_throughput (the output thread waiting on a worker's
device call and its copy to the host), summed over the window, per window.
Throughput driver only."""


def read(run):
    if run.cell.traffic["driver"] != "throughput":
        return None
    return run.span_ms_per_window("device_wait_transfer")
