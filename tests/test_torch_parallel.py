"""The PyTorch port's parallel package on the CPU against the JAX package.

MeshDecoder on `cpu` shards against the JAX MeshDecoder on the suite's 8
virtual CPU devices (tests/conftest.py), at meshes (1, 8) and (2, 4) with
the prefilter off and at 128 rows on both sides (the JAX package's auto
prefilter is off on the CPU and the port's is 2K, so both are set): the
decode summaries are identical, the survivor counts agree within 1 % (the
all-frames pattern's scan lags tie by construction, ROADMAP C), and found
rows index the padded grid. The multihost ranges equal the JAX functions',
and `python -m msk144cudecoder_tpu_torch.parallel` decodes a capture whose
two messages sit in different time rows, in one process and in two gloo
processes."""

import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msk144cudecoder_tpu import golden as G
from msk144cudecoder_tpu.config import DecoderConfig as JaxConfig
from msk144cudecoder_tpu.ops import pipeline as jpipeline
from msk144cudecoder_tpu.ops.tables import padded_freqs as jax_padded_freqs
from msk144cudecoder_tpu.parallel import multihost as jmultihost
from msk144cudecoder_tpu.parallel import sharding as jsharding
from msk144cudecoder_tpu.protocol import msg77
from msk144cudecoder_tpu_torch import constants as C
from msk144cudecoder_tpu_torch.config import DecoderConfig
from msk144cudecoder_tpu_torch.ops import pipeline
from msk144cudecoder_tpu_torch.ops.tables import padded_freqs
from msk144cudecoder_tpu_torch.parallel import MeshDecoder, make_mesh, multihost, stream_to_windows

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(search_width=100.0, scan_depth=3, max_survivors=64)  # tests/test_sharding.py's


@pytest.fixture(scope="module")
def raw():
    """A +10 dB ping at 1500 Hz (tests/test_sharding.py's) and a noise window."""
    audio = G.synthesize_audio_int16([("CQ K1ABC FN42", 1500.0)], 6, snr_db=10.0,
                                     rng=np.random.default_rng(5))
    noise = np.random.default_rng(0).normal(0, 1000, C.WINDOW_LEN).astype(np.int16)
    return np.stack([audio, noise])


def summary(res, cfg, freqs, b):
    """message -> lowest (num_avg, nbadsync, f0) over window b's found rows,
    and the count of found rows."""
    found = np.asarray(res.found[b])
    best = {}
    hashes = msg77.CallsignHashTable()
    for k in np.nonzero(found)[0]:
        ok, text = msg77.unpack77(pipeline.unpack_message_bits(
            np.asarray(res.message_bits[b][k])), hashes)
        if not ok:
            continue
        fi, pi, _ = pipeline.unpack_candidate_index(cfg, int(res.cand_index[b][k]))
        key = (int(C.PATTERN_NUM_AVG[pi]), int(res.nbadsync[b][k]), float(freqs[fi]))
        best[text] = min(best.get(text, key), key)
    return best, int(found.sum())


def test_padded_freqs_identical():
    for n_freq in (1, 3, 4, 8):
        cfg = DecoderConfig(**CFG)
        np.testing.assert_array_equal(padded_freqs(cfg.freqs, n_freq),
                                      jax_padded_freqs(JaxConfig(**CFG).freqs, n_freq))
    assert len(padded_freqs(DecoderConfig(**CFG).freqs, 8)) == 56


def test_make_mesh_and_framing():
    m = make_mesh(2, 4, ["cpu"] * 8)
    assert m.shape == (2, 4) and all(d == torch.device("cpu") for d in m.flat)
    with pytest.raises(ValueError):
        make_mesh(3, 3, ["cpu"] * 8)
    s = np.arange(C.WINDOW_LEN * 2 + 100, dtype=np.int16)
    np.testing.assert_array_equal(stream_to_windows(s, 1), jsharding.stream_to_windows(s, 1))
    iq = (np.arange(C.WINDOW_LEN * 5) % 127).astype(np.int8)
    np.testing.assert_array_equal(stream_to_windows(iq, 2), jsharding.stream_to_windows(iq, 2))


@pytest.mark.parametrize("prefilter", [0, 128])
@pytest.mark.parametrize("n_time,n_freq", [(1, 8), (2, 4)])
def test_mesh_decoder_matches_jax(raw, n_time, n_freq, prefilter):
    cfg = DecoderConfig(survivor_prefilter=prefilter, **CFG)
    md = MeshDecoder(cfg, make_mesh(n_time, n_freq, ["cpu"] * (n_time * n_freq)))
    jmd = jsharding.MeshDecoder(JaxConfig(survivor_prefilter=prefilter, use_pallas=False, **CFG),
                                jsharding.make_mesh(n_time, n_freq, jax.devices()[:n_time * n_freq]))
    ours = md.decode(raw)
    ref = jax.tree_util.tree_map(np.asarray, jmd.decode(raw))
    np.testing.assert_array_equal(md.freqs, jmd.freqs)
    assert ours.cand_index.shape == ref.cand_index.shape == (2, 64 * n_freq)
    for b in range(2):
        assert summary(ours, cfg, md.freqs, b) == summary(ref, cfg, md.freqs, b), b
    assert set(summary(ours, cfg, md.freqs, 0)[0]) == {"CQ K1ABC FN42"}
    assert summary(ours, cfg, md.freqs, 1)[0] == {}
    for f in ("num_survivors", "shard_survivors"):
        a, r = getattr(ours, f), getattr(ref, f)
        assert (np.abs(a - r) <= 0.01 * r).all(), (f, a, r)
    grid = len(md.freqs) * cfg.scan_depth * cfg.candidates_per_pattern
    assert (ours.cand_index[ours.found] < grid).all()
    np.testing.assert_allclose(ours.block_power, ref.block_power, rtol=1e-5)


@pytest.mark.parametrize("read_mode", [1, 2])
def test_host_ranges_match_jax(read_mode):
    for total in (1, 2, 5, 10, 37):
        for hosts in (1, 2, 3, 4):
            for host in range(hosts):
                assert (multihost.host_window_range(total, hosts, host)
                        == jmultihost.host_window_range(total, hosts, host))
                assert (multihost.host_sample_range(total, hosts, host, read_mode)
                        == jmultihost.host_sample_range(total, hosts, host, read_mode))


def test_global_mesh_and_distributed_args(monkeypatch):
    m = multihost.global_mesh(2, 4, "cpu")
    assert m.shape == (2, 4) and {str(d) for d in m.flat} == {"cpu"}
    assert multihost.global_mesh(device="cpu").shape == (1, 1)
    for var in ("MSK144_COORDINATOR", "MSK144_NUM_PROCESSES", "MSK144_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        multihost.init_distributed(None, 2, 0)


def parallel_capture(tmp_path) -> str:
    """tests/test_multihost.py's 5-window capture: message A in windows 0-1
    (time row 0 of a (2, x) mesh), message B in windows 3-4 (time row 1)."""
    rng = np.random.default_rng(5)
    a1 = G.synthesize_audio_int16([("CQ K1ABC FN42", 1500.0)], 6, snr_db=10.0, rng=rng)
    a2 = G.synthesize_audio_int16([("K1ABC W9XYZ R-03", 1480.0)], 6, snr_db=10.0, rng=rng)
    noise = rng.normal(0, 1000, C.HOP_LEN * 2).astype(np.int16)
    path = tmp_path / "capture.raw"
    path.write_bytes(np.concatenate([a1, noise, a2]).tobytes())
    return str(path)


def runner(*args):
    # two threads per process: several processes of torch's default
    # thread count on one CPU slow each other down many times over
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return [sys.executable, "-m", "msk144cudecoder_tpu_torch.parallel", "--device=cpu",
            "--search-width", "100", "--scan-depth", "3", *args], env


@pytest.mark.parametrize("mode", ["audio", "iq"])
def test_parallel_cli_single_process(tmp_path, mode):
    if mode == "audio":
        cap, want, extra = parallel_capture(tmp_path), {"CQ K1ABC FN42", "K1ABC W9XYZ R-03"}, []
    else:
        iq = G.synthesize_iq_int8([("CQ K1ABC FN42", 20.0)], 9, snr_db=8.0,
                                  rng=np.random.default_rng(6))
        cap = str(tmp_path / "capture.iq")
        pathlib.Path(cap).write_bytes(iq.tobytes())
        want, extra = {"CQ K1ABC FN42"}, ["--read-mode", "2"]
    cmd, env = runner("--input", cap, "--mesh-time", "2", "--mesh-freq", "4", *extra)
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    msgs = {ln.split("msg='")[1].split("'")[0] for ln in proc.stdout.splitlines() if "msg='" in ln}
    assert msgs == want
    assert proc.stdout.strip().endswith("Done")
    assert "Mesh: 2 (time) x 4 (freq) over 1 process(es), 1 device(s)" in proc.stderr


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_parallel_cli_two_processes(tmp_path):
    """Two gloo processes share the capture: each prints only its own time
    row's message, and rank 0 ends with Done."""
    cap = parallel_capture(tmp_path)
    port = free_port()
    procs = []
    for pid in range(2):
        cmd, env = runner("--input", cap, "--mesh-freq", "4", "--coordinator",
                          f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(pid))
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True, cwd=ROOT, env=env))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            p.kill()
    for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid}:\n{err[-3000:]}"
    assert "msg='CQ K1ABC FN42'" in outs[0][0] and "R-03" not in outs[0][0]
    assert "msg='K1ABC W9XYZ R-03'" in outs[1][0] and "FN42" not in outs[1][0]
    assert outs[0][0].strip().endswith("Done") and "Done" not in outs[1][0]
    assert "Mesh: 2 (time) x 4 (freq) over 2 process(es), 1 device(s)" in outs[0][1]
