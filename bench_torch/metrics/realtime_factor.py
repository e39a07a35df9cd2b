"""realtime_factor: audio seconds decoded over the wall time that took.

Windows post-processed x 0.216 s (one hop of new audio each) over the host
clock from the first window handed to the CLI loop to the loop's return:
all the work over all the time, the workers' graph captures at their first
batches included. Throughput driver only."""

HOP_S = 2592 / 12000.0


def read(run):
    w = run.window
    if run.cell.traffic["driver"] != "throughput" or not w.windows or w.wall_s <= 0:
        return None
    return run.answered * HOP_S / w.wall_s
