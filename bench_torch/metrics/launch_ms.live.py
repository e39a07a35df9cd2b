"""launch_ms.live: the program's `launch` span in StreamDecoder._run (the
graph's pass enqueued: the static copy, the replay and the copy out), its
mean over the window's decode_block calls, from the port's in-memory
recorder. Beside it in info: its mean inside the profiled slice
(`launch_ms_slice`) and outside it (`launch_ms_outside_slice`), which say
what the profiler adds to a graph launch. Live driver only."""

from bench_torch.common import program


def read(run):
    if run.cell.traffic["driver"] != "live":
        return None
    agg = program.aggregate("launch")
    if agg is None or not agg.count:
        return None
    if agg.profiled_count:
        program.note(run, "launch_ms_slice", agg.profiled_ns / agg.profiled_count / 1e6)
    if agg.count > agg.profiled_count:
        program.note(run, "launch_ms_outside_slice", (agg.total_ns - agg.profiled_ns)
                     / (agg.count - agg.profiled_count) / 1e6)
    return agg.total_ns / agg.count / 1e6
