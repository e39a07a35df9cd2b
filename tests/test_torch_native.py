"""The PyTorch port's native framer (runtime/native.py) against the numpy
framer: the cases of tests/test_native.py (audio and IQ windows at chunk
sizes 997 and 4096, drip-fed pushes, a bad read mode, the converters), the
short-read message at the end of a stream, and the build into the port's
_build/ (never into native/). Skipped only where g++ is missing."""

import contextlib
import io
import shutil

import numpy as np
import pytest

from msk144cudecoder_tpu_torch import constants as C
from msk144cudecoder_tpu_torch.runtime import native
from msk144cudecoder_tpu_torch.runtime.stream import window_stream


@pytest.fixture(scope="module", autouse=True)
def toolchain():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native framer")
    assert native.available()


def frames(fn, data: bytes, read_mode: int, **kw):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        out = list(fn(io.BytesIO(data), read_mode, **kw))
    return out, err.getvalue()


@pytest.mark.parametrize("read_mode,n_bytes,chunk", [
    (1, (C.WINDOW_LEN * 3 + 123) * 2, 997),
    (1, (C.WINDOW_LEN * 3 + 123) * 2 + 1, 4096),  # a ragged byte at the end
    (2, C.WINDOW_LEN * 5, 4096),
    (2, C.WINDOW_LEN * 5 + 77, 997),
])
def test_windows_and_tail_message_match_numpy(read_mode, n_bytes, chunk):
    data = (np.arange(n_bytes) % 251).astype(np.uint8).tobytes()
    py, py_err = frames(window_stream, data, read_mode)
    nat, nat_err = frames(native.native_window_stream, data, read_mode, chunk_bytes=chunk)
    assert len(py) == len(nat) >= 2
    for a, b in zip(py, nat):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert nat_err == py_err and py_err.startswith("Incomplete read error. rc=")


def test_incremental_push_pop():
    f = native.NativeFramer(1)
    s = np.arange(C.WINDOW_LEN + C.HOP_LEN, dtype=np.int16).tobytes()
    n_first = C.WINDOW_LEN * 2 - 1  # one byte short of a window
    assert f.push(s[:n_first]) == 0
    assert f.pop() is None
    assert f.push(s[n_first:]) == 2
    w0, w1 = f.pop(), f.pop()
    assert f.pop() is None
    np.testing.assert_array_equal(w1[: C.HOP_LEN], w0[C.HOP_LEN:])  # 50% overlap slide
    assert f.windows_emitted == 2 and f.pending_bytes == 0


def test_bad_read_mode():
    with pytest.raises(ValueError):
        native.NativeFramer(3)


def test_converters():
    x = np.random.default_rng(0).integers(-3000, 3000, C.WINDOW_LEN).astype(np.int16)
    out, rms = native.convert_int16_rms(x)
    want = np.sqrt(np.mean(x.astype(np.float64) ** 2))
    assert rms == pytest.approx(want, rel=1e-6)
    np.testing.assert_allclose(out, x.astype(np.float32) / want, rtol=1e-5)
    iq = np.random.default_rng(1).integers(-128, 128, 256).astype(np.int8)
    np.testing.assert_allclose(native.convert_iq8(iq), iq.astype(np.float32) / 128.0)


def test_built_into_the_port_build_dir():
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.SOURCE.parent.name == "native" and path.parent != native.SOURCE.parent
