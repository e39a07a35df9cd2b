"""untraced_idle.recording: of the card's idle time in the traced slice (the gaps
between its operations), the share in percent whose gap midpoint falls under
none of the program's `msk144.*` ranges on the main thread but for the
spans that wrap a whole request (common/program.py untraced_idle). Throughput driver only."""

from bench_torch.common import program


def read(run):
    if run.cell.traffic["driver"] != "throughput":
        return None
    return program.untraced_idle(run.slice)
