"""payload_share.recording: the distinct payloads a window's decoded rows
carry, as a share in percent of those rows: the program's counters
`unpack_payloads` (one memo lookup a payload, in
StreamDecoder._postprocess_one) over `unpack_lookups` (one a decoded row)
over the window. 100 where every row carries a payload of its own; the lower,
the more rows share one lookup. None where the program keeps no such counter.
Throughput driver only."""

from bench_torch.common import program


def read(run):
    rec = program.recorder()
    if run.cell.traffic["driver"] != "throughput" or rec is None:
        return None
    counters = rec.counters
    lookups = counters.get("unpack_lookups", 0)
    if not lookups or "unpack_payloads" not in counters:
        return None
    return 100.0 * counters["unpack_payloads"] / lookups
