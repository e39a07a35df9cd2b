"""survivor_cover.recording: the share of a window's sync survivors that BP
decodes, in percent: the program's counters `survivors_decoded` (each
window's min(num_survivors, K)) over `grid_survivors` (each window's
num_survivors, the rows under the nbadsync threshold), both counted in
StreamDecoder._postprocess_one over the window. num_survivors counts every
row of the candidate grid only on the full-demod path (survivor_prefilter
0); behind the prefilter it counts the prefiltered rows, a lower bound.
min(num_survivors, K) is the rows BP takes on one device where every
pattern's survivors fill its per-pattern quota or all fit in it (in
deep_full each pattern holds about 2,400 survivors against a quota of 1024),
and more than it takes otherwise. The share is set by the configuration's K
and the traffic: it moves only with what is decoded, and a higher share
costs realtime_factor. None without a recorder or without the counters (a
program older than them). Throughput driver only."""

from bench_torch.common import program


def read(run):
    rec = program.recorder()
    if run.cell.traffic["driver"] != "throughput" or rec is None:
        return None
    counters = rec.counters
    grid = counters.get("grid_survivors", 0)
    if not grid or "survivors_decoded" not in counters:
        return None
    return 100.0 * counters["survivors_decoded"] / grid
