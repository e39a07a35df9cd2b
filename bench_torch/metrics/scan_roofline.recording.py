"""scan_roofline.recording: the sync scan's share of its roofline, in
percent: the least time of one pass's scan (the cell's batch of windows,
its F channels, depth, k and lag grid; common/roofline.py scan_bound) over
the mean device time per launch of the scan kernel, either instantiation,
in the traced slice."""

from bench_torch.common import roofline

KERNEL = r"\bscan_(fast_)?kernel\b"


def read(run):
    s = run.slice
    if run.cell.traffic["driver"] != "throughput" or s is None or not s.done:
        return None
    ns, launches = s.kernel_ns(KERNEL)
    if not launches or ns <= 0:
        return None
    st = run.settings
    ms, _ = roofline.scan_bound(run.cell.traffic["window_batch"], len(st.freqs), st.scan_depth,
                                st.candidates_per_pattern, st.scan_decimation)
    return 100.0 * ms / (ns / launches / 1e6)
