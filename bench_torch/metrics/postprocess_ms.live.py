"""postprocess_ms.live: the program's `postprocess` span in
StreamDecoder.collect (unpack77, the result filter, the SNR tracker),
summed over the window, per window. Live driver only."""


def read(run):
    if run.cell.traffic["driver"] != "live":
        return None
    return run.span_ms_per_window("postprocess")
