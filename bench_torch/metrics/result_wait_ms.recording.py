"""result_wait_ms.recording: how long a batch's finished result waits for
the CLI's main thread, in ms: per batch, from the end of the worker's
`decode_to_host` span to the start of that batch's `drain` span (the two
paired by the batch's request id), 0 where the drain began first (the main
thread waited on the worker), the mean over the window's batches; from the
port's in-memory recorder. Beside it in info: the share of batches whose
drain began first. Throughput driver only."""

from bench_torch.common import program


def read(run):
    rec = program.recorder()
    if run.cell.traffic["driver"] != "throughput" or rec is None:
        return None
    done = {s.rid: s.end_ns for s in rec.spans("decode_to_host") if s.rid is not None}
    waits = [d.start_ns - done[d.rid] for d in rec.spans("drain") if d.rid in done]
    if not waits:
        return None
    program.note(run, "result_wait_drain_first", sum(w <= 0 for w in waits) / len(waits))
    return sum(max(w, 0) for w in waits) / len(waits) / 1e6
