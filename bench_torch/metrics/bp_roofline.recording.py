"""bp_roofline.recording: LDPC belief propagation's share of its roofline,
in percent: the least time of the message updates one pass's K rows a
window need (common/roofline.py bp_bound), over the mean device time per
launch of the BP kernel, either instantiation, in the traced slice. The
updates are counted as these inputs need them, from the reference's decode
of the sampled windows (its mean per window times the batch), not as many
as the rows could take."""

from bench_torch.common import roofline

KERNEL = r"\bbp_kernel\b"


def read(run):
    s = run.slice
    info = run.check.get("info", {})
    if run.cell.traffic["driver"] != "throughput" or s is None or not s.done \
            or not info.get("windows_compared"):
        return None
    ns, launches = s.kernel_ns(KERNEL)
    if not launches or ns <= 0:
        return None
    batch = run.cell.traffic["window_batch"]
    st = run.settings
    rows = batch * st.max_survivors
    ms, _ = roofline.bp_bound(info["bp_updates_per_window"] * batch, rows)
    return 100.0 * ms / (ns / launches / 1e6)
