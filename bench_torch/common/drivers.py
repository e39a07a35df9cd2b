"""What the drivers share. A driver is the port's entry point as the
measured window runs it: `drivers/<name>.py`, named by the traffic file's
`driver` key and found by `load`, with `warm(decoder, windows, traffic, n,
sink)` (the entry on the stream's first n windows, untimed) and `run(decoder,
windows, traffic, clock, sink) -> Window` (the entry, closed loop, on the
windows `clock` hands out until the window's time is up).

`recorder` wraps the decoder class: it counts the windows the decoder
answers and keeps, in a reservoir drawn from the seed, the answers of a
sample of the window's windows (their lines and decoded rows) for the
comparison with the reference.
"""

from __future__ import annotations

import contextlib
import importlib.util
import pathlib
import random
import time
from typing import Callable, Iterator, List, NamedTuple, Optional

import numpy as np


class Replay:
    """A binary stream of the recording's bytes, replayed from the start
    when it ends, for as long as it is read."""

    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0

    def read(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            take = min(n - len(out), len(self._data) - self._pos)
            out += self._data[self._pos: self._pos + take]
            self._pos = (self._pos + take) % len(self._data)
        return bytes(out)


class Answer(NamedTuple):
    window: int  # index in the stream, warm-up included
    items: list  # the ResultItems the decoder returned for it
    cand_index: np.ndarray  # its decoded rows
    pos: np.ndarray
    xb: np.ndarray


def recorder(base, skip: int, sample: int, seed: int, label: Callable = None):
    """A subclass of the StreamDecoder class `base` that counts the windows
    it post-processes and keeps a uniform sample of `sample` of those after
    the first `skip` (the warm-up). `label(name)`, when given, is a context
    manager put around the public calls (the traced run's host spans)."""
    rnd = random.Random(seed)
    span = label or (lambda name: contextlib.nullcontext())

    class Recorder(base):
        answered = 0
        kept: List[Answer] = []

        def _postprocess_one(self, res, b):
            with span("postprocess_window"):
                items = super()._postprocess_one(res, b)
            i = self.answered
            self.answered = i + 1
            j = i - skip
            if j < 0:
                return items
            slot = j if j < sample else int(rnd.random() * (j + 1))
            if slot < sample:
                f = np.asarray(res.found[b], dtype=bool)
                ans = Answer(i, items, *(np.array(np.asarray(getattr(res, k)[b])[f])
                                         for k in ("cand_index", "pos", "xb")))
                if j < sample:
                    self.kept.append(ans)
                else:
                    self.kept[slot] = ans
            return items

        def decode_to_host(self, raw_batch):
            with span("decode_to_host"):
                return super().decode_to_host(raw_batch)

        def postprocess_batch(self, res, n_valid):
            with span("postprocess_batch"):
                return super().postprocess_batch(res, n_valid)

        def submit(self, raw_window):
            with span("submit"):
                return super().submit(raw_window)

        def collect(self):
            with span("collect"):
                return super().collect()

    Recorder.kept = []
    return Recorder


class Window(NamedTuple):
    """What a driver measured."""

    windows: int  # windows handed to the entry
    wall_s: float  # host clock, first window handed to the entry's return
    latencies_ms: Optional[np.ndarray]  # per call into the entry, host clock (live)
    framing_s: float  # host clock inside the framer's next(), summed
    per_second: List[int]  # windows handed to the entry in each second of the window


class Clock:
    """The window's deadline and the traced slice's start and stop, checked
    each time the driver asks the framer for a window."""

    def __init__(self, seconds: float, trace_slice=None, start_frac: float = 0.4,
                 slice_s: float = 1.0, label: Callable = None):
        self.seconds = seconds
        self.slice = trace_slice
        self.slice_at = start_frac * seconds
        self.slice_s = slice_s
        self.label = label or (lambda name: contextlib.nullcontext())
        self.t0: Optional[float] = None
        self.n = 0
        self.framing_s = 0.0
        self.per_second: List[int] = []  # windows handed out in each second

    def windows(self, it: Iterator[np.ndarray]) -> Iterator[np.ndarray]:
        """`it` until the window's time is up; the first window handed out
        starts the window."""
        while True:
            now = time.perf_counter()
            if self.t0 is None:
                self.t0 = now
            elapsed = now - self.t0
            if elapsed >= self.seconds:
                if self.slice is not None and self.slice.active:
                    self.slice.stop()
                return
            if self.slice is not None:
                if not self.slice.done and not self.slice.active and elapsed >= self.slice_at:
                    self.slice.start()
                elif self.slice.active and self.slice.elapsed() >= self.slice_s:
                    self.slice.stop()
                if self.slice.active:
                    self.slice.passes += 1
            t = time.perf_counter()
            with self.label("framing"):
                w = next(it)
            self.framing_s += time.perf_counter() - t
            self.n += 1
            sec = int(elapsed)
            if sec >= len(self.per_second):
                self.per_second += [0] * (sec + 1 - len(self.per_second))
            self.per_second[sec] += 1
            yield w


def load(name: str):
    """The module drivers/<name>.py."""
    path = pathlib.Path(__file__).resolve().parent.parent / "drivers" / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"error: no driver {name!r} (drivers/{name}.py)")
    spec = importlib.util.spec_from_file_location(f"bench_torch_driver_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
