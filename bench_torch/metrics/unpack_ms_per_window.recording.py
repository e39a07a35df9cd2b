"""unpack_ms_per_window.recording: the program's `unpack77` span in
StreamDecoder._postprocess_one (each decoded payload to text through the
unpack memo), summed over the window, per window handed to the CLI loop;
from the port's in-memory recorder. Throughput driver only."""

from bench_torch.common import program


def read(run):
    if run.cell.traffic["driver"] != "throughput" or not run.window.windows:
        return None
    agg = program.aggregate("unpack77")
    if agg is None:
        return None
    return agg.total_ns / 1e6 / run.window.windows
