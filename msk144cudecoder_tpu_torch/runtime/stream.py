"""Binary stream framing with 50% window overlap.

Mirror of the reference's fread loop (reference src/main.cu:261-386):
first read fills a whole 5184-sample window; every subsequent iteration slides
the second half down and reads 2592 new samples. Audio mode consumes int16
mono; IQ mode consumes interleaved int8 pairs (so 2x the byte count per
sample). Short reads end the stream, matching main.cu:276-293.
"""

from __future__ import annotations

import sys
from typing import BinaryIO, Iterator

import numpy as np

from .. import constants as C


def window_stream(fp: BinaryIO, read_mode: int) -> Iterator[np.ndarray]:
    """Yield raw windows: int16 (5184,) for audio, int8 (10368,) for IQ."""
    if read_mode == 1:
        dtype, per_sample = np.int16, 1
    elif read_mode == 2:
        dtype, per_sample = np.int8, 2
    else:
        raise ValueError(f"read_mode must be 1 or 2, got {read_mode}")

    n_full = C.WINDOW_LEN * per_sample
    n_half = n_full // 2
    itemsize = np.dtype(dtype).itemsize

    def read_exact(n_items: int):
        data = fp.read(n_items * itemsize)
        # a stream ending mid-sample (ragged byte tail) takes the normal
        # short-read exit instead of a frombuffer ValueError
        data = data[: (len(data) // itemsize) * itemsize]
        arr = np.frombuffer(data, dtype=dtype)
        if len(arr) != n_items:
            # EOF/short read ends the stream (main.cu:276-293 prints the same)
            print(f"Incomplete read error. rc={len(arr)}", file=sys.stderr)
            return None
        return arr

    buf = read_exact(n_full)
    if buf is None:
        return
    buf = np.array(buf)  # writable copy
    yield buf.copy()

    while True:
        new = read_exact(n_half)
        if new is None:
            return
        buf[:n_half] = buf[n_half:]
        buf[n_half:] = new
        yield buf.copy()
