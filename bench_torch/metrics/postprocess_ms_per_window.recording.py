"""postprocess_ms_per_window.recording: the program's `postprocess` span in
cli.decode_throughput (StreamDecoder.postprocess_batch: unpack77, the
result filter, the SNR tracker, overflow warnings, and the decode lines'
output), summed over the window, per window. Throughput driver only."""


def read(run):
    if run.cell.traffic["driver"] != "throughput":
        return None
    return run.span_ms_per_window("postprocess")
