"""The port's tracing (runtime/metrics.py), on the CPU: nothing is recorded
with the switch off; spans nest per thread and a batch's spans share its
request id from framing to post-processing, with no span for the empty read
at the stream's end; a new recording starts empty on every thread; a pass
is a graph capture at its stream's first shape only; the eight spans the reference
prints keep its format and nesting on standard error, and no other span
prints; the unpack memo's counters equal a direct count from the fetched
result; under a torch profiler a span is an `msk144.<name>` range that the
recorder's anchor places on the trace's clock; the CLI's --profile-dir
trace carries the spans of every thread."""

import contextlib
import io
import json
import re
import threading
import time

import numpy as np
import pytest
import torch

from msk144cudecoder_tpu_torch import cli, stimulus
from msk144cudecoder_tpu_torch.config import DecoderConfig
from msk144cudecoder_tpu_torch.runtime import StreamDecoder, metrics, native

torch.set_num_threads(2)
CFG = DecoderConfig(search_width=20.0, scan_depth=3)  # F = 11: a fast CPU pass
LINE = re.compile(r"^( *)Measured time: (\S+) (\d+\.\d{3}) ms$")


@pytest.fixture(scope="module")
def windows():
    from pathlib import Path

    raw = np.fromfile(Path(__file__).resolve().parents[1] / "demo" / "capture.raw", dtype=np.int16)
    return list(stimulus.stream_windows(raw))


class Every:
    def __contains__(self, name):
        return True


@pytest.fixture
def switch(monkeypatch):
    """Turns the switch on or off as the next public call reads it; every
    span kept. Off again, and read, after the test."""
    monkeypatch.setattr(metrics, "KEPT", Every())

    def turn(on: bool):
        monkeypatch.setenv(metrics.ENV, "1" if on else "0")
        metrics.refresh()

    yield turn
    monkeypatch.setenv(metrics.ENV, "0")
    metrics.refresh()


def quiet(fn, *args):
    """fn(*args) with stdout dropped; returns (its result, stderr)."""
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
        out = fn(*args)
    return out, err.getvalue()


def test_switch_off_records_nothing(switch, windows):
    switch(True)  # a fresh recording
    switch(False)
    dec = StreamDecoder(CFG, "cpu")
    _, err = quiet(lambda: (dec.decode_block(windows[0]),
                            cli.decode_throughput(dec, iter(windows[:3]), 2, 2)))
    rec = metrics.recorder()
    assert rec.aggregates == {} and not rec.kept and not rec.counters
    assert "Measured time" not in err


def test_throughput_spans_nest_per_thread_and_share_the_batch_id(switch, windows):
    switch(True)
    dec = StreamDecoder(CFG, "cpu")
    quiet(cli.decode_throughput, dec, iter(windows[:5]), 2, 2)  # batches 0, 1, 2 (padded)
    rec = metrics.recorder()
    spans = list(rec.kept)
    by_id = {s.sid: s for s in spans}
    main = threading.get_ident()
    for seq in range(3):
        mine = {s.name: s for s in spans if s.rid == seq and s.parent is None}
        assert set(mine) == {"frame_batch", "decode_to_host", "drain"}, (seq, mine)
        assert mine["frame_batch"].thread == main and mine["drain"].thread == main
        assert mine["decode_to_host"].thread != main  # a worker's, a root on its thread
        assert mine["frame_batch"].end_ns <= mine["decode_to_host"].start_ns
    for s in spans:
        if s.parent is None:
            continue
        p = by_id[s.parent]
        assert (p.thread, p.rid) == (s.thread, s.rid), (s, p)
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        want = {"h2d": "decode_to_host", "launch": "decode_to_host",
                "device_wait_transfer": "drain", "postprocess": "drain",
                "unpack77": "postprocess", "result_filter": "postprocess"}[s.name]
        assert p.name == want, (s, p)
    agg = rec.aggregates
    assert agg["decode_to_host"].count == agg["drain"].count == agg["frame_batch"].count == 3
    assert agg["postprocess"].count == 3 and agg["unpack77"].count == 5  # 5 real windows
    for name, a in agg.items():
        assert 0 <= a.self_ns <= a.total_ns, name
    children = agg["h2d"].total_ns + agg["launch"].total_ns
    assert agg["decode_to_host"].self_ns == agg["decode_to_host"].total_ns - children


def test_a_whole_last_batch_opens_no_empty_batch_span(switch, windows):
    switch(True)
    dec = StreamDecoder(CFG, "cpu")
    quiet(cli.decode_throughput, dec, iter(windows[:4]), 2, 2)  # two full batches, then the end
    rec = metrics.recorder()
    for name in ("frame_batch", "decode_to_host", "drain"):
        assert sorted(s.rid for s in rec.spans(name)) == [0, 1], name


def test_decode_block_spans_carry_the_window_number(switch, windows):
    dec = StreamDecoder(CFG, "cpu")
    quiet(dec.decode_block, windows[0])  # call 1, switch off
    switch(True)
    for w in windows[1:4]:
        quiet(dec.decode_block, w)
    rec = metrics.recorder()
    for name in ("h2d", "launch", "device_wait_transfer", "postprocess", "unpack77"):
        assert [s.rid for s in rec.spans(name)] == [2, 3, 4], name
    assert "decode_block" not in rec.aggregates  # a request, not a span of its own
    by_id = {s.sid: s for s in rec.kept}
    assert all(s.parent is None for s in rec.spans("h2d") + rec.spans("postprocess"))
    assert all(by_id[s.parent].name == "postprocess" for s in rec.spans("unpack77"))


def test_a_new_recording_forgets_every_threads_tallies(switch):
    switch(True)

    def work():
        with metrics.ScopedMetric("launch"):
            metrics.count("memo_hits", 2)

    t = threading.Thread(target=work)
    t.start()
    t.join()
    work()
    rec = metrics.recorder()
    assert rec.aggregates["launch"].count == 2 and rec.counters["memo_hits"] == 4
    switch(False)
    switch(True)
    assert rec.aggregates == {} and not rec.counters and not rec.kept
    work()
    assert rec.aggregates["launch"].count == 1 and rec.counters["memo_hits"] == 2


def test_a_pass_is_a_capture_at_its_streams_first_shape_only():
    """GraphedPipeline.run's decision, on its key (shape, dtype, stream
    handle): a key's first pass captures (no graph, `graph_capture`), and
    once its graph is held a pass replays it under `launch`."""
    from msk144cudecoder_tpu_torch.ops.graphs import graph_for

    held = {}

    def pass_(x, stream=7):
        key = (tuple(x.shape), x.dtype, stream)
        g, name = graph_for(held, key)
        assert (g is None) == (name == "graph_capture") and g is held.get(key)
        held.setdefault(key, object())  # run's capture stores the key's graph
        return name

    one, two = torch.zeros(1, 8, dtype=torch.int16), torch.zeros(2, 8, dtype=torch.int16)
    assert [pass_(x) for x in (one, one, two, one, two)] == [
        "graph_capture", "launch", "graph_capture", "launch", "launch"]
    assert pass_(one.float()) == "graph_capture"
    assert [pass_(one, stream=8), pass_(one, stream=8), pass_(one)] == [
        "graph_capture", "launch", "launch"]


def reference_lines(n_windows: int):
    """(indent, name) of the reference's printed spans, in order, for the
    window-by-window loop over n_windows windows (depth-1 pipelining)."""
    def collect(level):
        return [(level + 1, "device_wait_transfer"), (level + 2, "unpack77"),
                (level + 2, "result_filter"), (level + 1, "postprocess"), (level, "collect")]

    out = []
    for i in range(n_windows):
        out += [(1, "ingest"), (1, "submit")]
        if i:
            out += collect(1)
        out.append((0, "working_loop"))
    return out + [(1, "ingest"), (0, "working_loop")] + collect(0)


def printed(err: str):
    rows = []
    for line in err.splitlines():
        if "Measured time" in line:
            m = LINE.match(line)
            assert m, line
            rows.append((len(m.group(1)) // 2, m.group(2)))
    return rows


def test_printed_spans_keep_the_reference_format_and_nesting(switch, windows):
    switch(True)
    dec = StreamDecoder(CFG, "cpu")
    _, err = quiet(cli.decode_windowed, dec, iter(windows[:3]))
    assert printed(err) == reference_lines(3)
    _, err = quiet(cli.decode_throughput, dec, iter(windows[:3]), 2, 2)
    batch = [(0, "device_wait_transfer")]
    assert printed(err) == (batch + [(1, "unpack77"), (1, "result_filter")] * 2 + [(0, "postprocess")]
                            + batch + [(1, "unpack77"), (1, "result_filter"), (0, "postprocess")])
    assert {name for _, name in printed(err)} <= metrics.PRINTED
    assert {"frame_batch", "drain", "decode_to_host", "h2d", "launch"} <= set(
        metrics.recorder().aggregates)


def test_memo_counters_equal_a_direct_count(switch, windows):
    """Counted from the fetched result: a lookup per decoded row, a hit per
    row whose payload an earlier row carried (the memo starts empty and
    keeps every payload of 8 windows), a payload per distinct payload of a
    window."""
    fetched = []

    class Kept(StreamDecoder):
        def decode_to_host(self, raw_batch):
            fetched.append(super().decode_to_host(raw_batch))
            return fetched[-1]

    switch(True)
    dec = Kept(CFG, "cpu")
    quiet(dec.decode_many, np.stack(windows[:8]))
    (res,) = fetched
    seen = set()
    lookups = hits = payloads = 0
    for b in range(len(res.found)):
        keys = [res.message_bits[b][k].tobytes() for k in np.flatnonzero(res.found[b])]
        lookups += len(keys)
        payloads += len(set(keys))
        for key in keys:
            hits += key in seen
            seen.add(key)
    counters = metrics.recorder().counters
    assert lookups > payloads and lookups > hits > 0
    assert list(dec._decode_cache) == list(dict.fromkeys(
        res.message_bits[b][k].tobytes() for b in range(len(res.found))
        for k in np.flatnonzero(res.found[b])))
    assert (counters["unpack_lookups"], counters["memo_hits"], counters["unpack_payloads"]) == (
        lookups, hits, payloads)


def test_profiler_sees_each_span_where_the_anchor_puts_it(switch):
    from torch.profiler import ProfilerActivity, profile

    switch(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(8):
            with metrics.ScopedMetric("launch"):
                time.sleep(0.002)
    rec = metrics.recorder()
    ours = rec.spans("launch")
    events = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                    if e.name() == "msk144.launch")
    assert len(events) == len(ours) == 8
    assert rec.aggregates["launch"].profiled_count == 8
    gaps_us = [abs(e - rec.unix_ns(s.start_ns)) / 1e3 for e, s in zip(events, ours)]
    assert sorted(gaps_us)[len(gaps_us) // 2] < 100, gaps_us


def test_profile_dir_trace_carries_every_threads_spans(tmp_path, windows):
    if not native.available():
        pytest.skip("the native framer did not build: --profile-dir is traced through it here")
    raw = np.concatenate([w[-2592:] for w in windows[:6]])  # about 6 hops of audio
    stdin = io.BytesIO(raw.astype(np.int16).tobytes())

    class Stdin:
        buffer = stdin

    import sys

    old = sys.stdin
    sys.stdin = Stdin
    try:
        quiet(cli.main, ["--device=cpu", "--search-width=20", "--scan-depth=3", "--window-batch=2",
                         "--pipeline-depth=2", f"--profile-dir={tmp_path}"])
    finally:
        sys.stdin = old
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    tids = {}
    for e in events:
        if str(e.get("name", "")).startswith("msk144."):
            tids.setdefault(e["name"], set()).add(e.get("tid"))
    assert {"msk144.frame", "msk144.frame_batch", "msk144.drain", "msk144.decode_to_host",
            "msk144.launch"} <= set(tids), sorted(tids)
    assert not tids["msk144.decode_to_host"] & tids["msk144.frame_batch"]
