"""survivor_roofline.recording: the survivor demod's share of its roofline,
in percent: the least time of one pass's demod of the prefiltered rows (the
cell's batch of windows x 512 rows, in the patterns' equal quotas;
common/roofline.py survivor_bound) over the mean device time per launch of
the survivor kernel, either instantiation, in the traced slice."""

from bench_torch.common import reference, roofline

KERNEL = r"\bsurvivor_kernel\b"


def read(run):
    s = run.slice
    if run.cell.traffic["driver"] != "throughput" or s is None or not s.done:
        return None
    ns, launches = s.kernel_ns(KERNEL)
    if not launches or ns <= 0:
        return None
    st = run.settings
    F = len(st.freqs)
    rows = reference.prefilter_size(st, F * st.scan_depth * st.candidates_per_pattern)
    ms, _ = roofline.survivor_bound(run.cell.traffic["window_batch"], rows, F, st.scan_depth)
    return 100.0 * ms / (ns / launches / 1e6)
