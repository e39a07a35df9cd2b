"""h2d_ms.live: the program's `h2d` span in StreamDecoder._run (the window
from host memory to the card, under submit), its mean over the window's
decode_block calls, one a window, from the port's in-memory recorder. Live
driver only."""

from bench_torch.common import program


def read(run):
    if run.cell.traffic["driver"] != "live":
        return None
    agg = program.aggregate("h2d")
    if agg is None or not agg.count:
        return None
    return agg.total_ns / agg.count / 1e6
