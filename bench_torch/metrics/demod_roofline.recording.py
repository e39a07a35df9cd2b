"""demod_roofline.recording: the full demod's share of its roofline, in
percent: the least time of one pass's demod of every candidate of the grid
(the cell's batch of windows x F channels x depth x k rows; common/roofline.py
demod_bound, float32 as the configurations state it) over the mean device
time per launch of the full-demod kernel, either instantiation, in the
traced slice. Only the full-demod path (survivor_prefilter 0) launches it;
elsewhere it reads None."""

from bench_torch.common import roofline

KERNEL = r"\bdemod_kernel\b"


def read(run):
    s = run.slice
    if run.cell.traffic["driver"] != "throughput" or s is None or not s.done:
        return None
    ns, launches = s.kernel_ns(KERNEL)
    if not launches or ns <= 0:
        return None
    st = run.settings
    ms, _ = roofline.demod_bound(run.cell.traffic["window_batch"], len(st.freqs), st.scan_depth,
                                 st.candidates_per_pattern)
    return 100.0 * ms / (ns / launches / 1e6)
