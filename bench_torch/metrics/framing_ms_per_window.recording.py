"""framing_ms_per_window.recording: the port's native framer
(runtime/native.py, the C++ ring buffer) per window: the harness's
host-clock span around each next() of the window iterator the CLI loop
pulls from, summed over the window, over the windows framed. Each span is a
few microseconds; the sum spans the window. Throughput driver only."""


def read(run):
    w = run.window
    if run.cell.traffic["driver"] != "throughput" or run.spans is None or not w.windows:
        return None
    return w.framing_s * 1e3 / w.windows
