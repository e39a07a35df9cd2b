"""graph_capture_ms.recording: the program's `graph_capture` spans (a
worker's first pass on a new CUDA stream: the eager pass and the capture of
its graph) summed over the window, in ms; their count in info
(`graph_captures`). 0 where the window captured none (the CPU captures
none). From the port's in-memory recorder; throughput driver only."""

from bench_torch.common import program


def read(run):
    rec = program.recorder()
    if run.cell.traffic["driver"] != "throughput" or rec is None \
            or "decode_to_host" not in rec.aggregates:
        return None
    agg = rec.aggregates.get("graph_capture")
    program.note(run, "graph_captures", agg.count if agg else 0)
    return agg.total_ns / 1e6 if agg else 0.0
