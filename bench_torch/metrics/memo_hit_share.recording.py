"""memo_hit_share.recording: the unpack memo's hit share in percent: the
program's counters `memo_hits` over `unpack_lookups`
(StreamDecoder._unpack_cached, one lookup a decoded payload) over the
window. Throughput driver only."""

from bench_torch.common import program


def read(run):
    rec = program.recorder()
    if run.cell.traffic["driver"] != "throughput" or rec is None:
        return None
    lookups = rec.counters.get("unpack_lookups", 0)
    if not lookups:
        return None
    return 100.0 * rec.counters.get("memo_hits", 0) / lookups
