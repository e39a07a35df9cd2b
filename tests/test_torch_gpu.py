"""The PyTorch port's CUDA kernels against their plain torch versions on the
card, decode_to_host from several threads on their own CUDA streams, the
frequency-sharded MeshDecoder on one card against its CPU run, and the CUDA
graphs of the pipeline (ops/graphs.py) against its eager pass. Marked
`gpu`: each test skips without a CUDA device (the CPU suite checks the
plain versions against the JAX package instead). On a machine with a card
and nvcc, and without jax (tests/conftest.py imports it):
    python -m pytest --noconftest tests/test_torch_gpu.py -q
The tolerances are those of chip_smoke.py. The bf16 instantiations
(DecoderConfig.fast_math) are held against the fast plain versions by the
battery's checks (tools/run_hwtests.py check_scan, check_survivor,
check_bp, check_demod), whose rules PERF.md section 6 states."""

import pathlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from msk144cudecoder_tpu_torch import constants as C
from msk144cudecoder_tpu_torch import stimulus
from msk144cudecoder_tpu_torch.config import DecoderConfig
from msk144cudecoder_tpu_torch.ops import demod, kernels, ldpc, pipeline, scan, survivor
from msk144cudecoder_tpu_torch.parallel import MeshDecoder, make_mesh
from msk144cudecoder_tpu_torch.protocol import crc, ldpc_tables, msg77
from msk144cudecoder_tpu_torch.runtime import StreamDecoder
from msk144cudecoder_tpu_torch.tools import run_hwtests as hw

pytestmark = pytest.mark.gpu
DEMO = pathlib.Path(__file__).resolve().parents[1] / "demo" / "capture.raw"


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.library()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def setup(cuda):
    """A default-config pipeline on the card and 4 analytic windows: three
    demo windows with pings and one of noise."""
    cfg = DecoderConfig()
    demo = np.fromfile(DEMO, dtype=np.int16)
    raw = np.stack([*stimulus.stream_windows(demo)[[2, 10, 20]],
                    np.random.default_rng(0).normal(0, 1000, 5184).astype(np.int16)])
    pipe = pipeline.DecodePipeline(cfg).to(cuda)
    return cfg, pipe, pipe.preprocess(torch.from_numpy(raw).to(cuda))


@pytest.mark.parametrize("dec", [1, 4])
def test_scan_kernel_matches_plain(setup, dec):
    cfg, _, c = setup
    pipe = pipeline.DecodePipeline(cfg.replace(scan_decimation=dec)).to(c.device)
    args = (c, pipe.B, pipe.E_dec, pipe.chi, 6, 8, dec)
    pos_k, xb_k = scan.scan_cuda(*args)
    pos_p, xb_p = scan.scan_plain(*args)
    torch.testing.assert_close(xb_k, xb_p, rtol=1e-4, atol=1e-4)
    mism = (pos_k != pos_p).cpu().numpy()
    assert mism[:, :, [0, 1, 2, 3, 4]].mean() <= 0.01  # pattern 5 ties by construction
    rel = ((xb_k - xb_p).abs() <= 1e-4 * xb_p.abs()).cpu().numpy()
    assert rel[mism].all()


DEEP = dict(search_width=500.0, search_step=1.0, scan_depth=6, nbadsync_threshold=3)


def demo_batch(cuda, cfg, n):
    """A pipeline for cfg on the card and n analytic demo windows (the
    capture's 26 windows in turn)."""
    windows = stimulus.stream_windows(np.fromfile(DEMO, dtype=np.int16))
    raw = torch.from_numpy(np.stack([windows[i % len(windows)] for i in range(n)])).to(cuda)
    pipe = pipeline.DecodePipeline(cfg).to(cuda)
    return pipe, pipe.preprocess(raw)


@pytest.mark.parametrize("kw,n_win", [
    (dict(), 64),  # the main path's batch
    (DEEP, 64),  # the deep scan's batch
    (dict(), 1),  # one window: one frequency per block
    (dict(scan_decimation=2), 8),
    (dict(scan_decimation=1), 8),
    (dict(scan_depth=8, candidates_per_pattern=5), 16),  # the gap patterns
    (dict(search_width=12.0), 64),  # F = 7: a ragged last tile
])
def test_scan_kernel_main_path_shapes(cuda, kw, n_win):
    """Kernel B1 against its plain version at the shapes the main path gives
    it, with the tolerance of test_scan_kernel_matches_plain."""
    cfg = DecoderConfig(**kw)
    pipe, c = demo_batch(cuda, cfg, n_win)
    args = (c, pipe.B, pipe.E_dec, pipe.chi, cfg.scan_depth, cfg.candidates_per_pattern,
            cfg.scan_decimation)
    pos_k, xb_k = scan.scan_cuda(*args)
    pos_p, xb_p = scan.scan_plain(*args)
    torch.testing.assert_close(xb_k, xb_p, rtol=1e-4, atol=1e-4)
    assert ((pos_k % cfg.scan_decimation == 0) & (pos_k >= 0) & (pos_k < C.WINDOW_LEN)).all()
    mism = (pos_k != pos_p).cpu().numpy()
    untied = [p for p in range(cfg.scan_depth) if p != 5]
    assert mism[:, :, untied].mean() <= 0.01
    rel = ((xb_k - xb_p).abs() <= 1e-4 * xb_p.abs()).cpu().numpy()
    assert rel[mism].all()


def test_bp_kernel_on_main_path_rows(cuda):
    """Kernel B3 on the rows the main path hands it: the selected survivors
    of 64 demo windows (16,384 rows), every output identical."""
    pipe, c = demo_batch(cuda, DecoderConfig(), 64)
    front = pipe.prefilter(*pipe.scan(c))
    prep = pipe.select(*pipe.demod(c, front), front)
    llr, valid = prep.llr.reshape(-1, 128).contiguous(), prep.valid.reshape(-1).contiguous()
    assert llr.shape == (16384, 128)
    r_k = ldpc.bp_decode_cuda(llr, valid, pipe.ldpc_tables)
    r_p = ldpc.bp_decode_plain(llr, valid, pipe.ldpc_tables)
    for f in r_k._fields:
        assert torch.equal(getattr(r_k, f), getattr(r_p, f)), f
    assert r_k.found.any()


def test_bp_kernel_decodes_at_iteration_0(cuda):
    """Clean codewords decode before the first update; among noise rows and
    rows marked invalid, every output stays identical."""
    rng = np.random.default_rng(2)
    rows = []
    for i in range(96):
        msg = rng.integers(0, 2, 77)
        cw = ldpc_tables.encode(np.concatenate([msg, (crc.CRC_MATRIX @ msg) % 2]))
        rows.append((2.0 * cw - 1.0) * 4.0 if i % 3 else rng.normal(0, 2.0, 128))
    llr = torch.from_numpy(np.stack(rows).astype(np.float32)).to(cuda)
    valid = torch.arange(96, device=cuda) % 4 != 1
    lt = pipeline.DecodePipeline(DecoderConfig()).to(cuda).ldpc_tables
    r_k = ldpc.bp_decode_cuda(llr, valid, lt)
    r_p = ldpc.bp_decode_plain(llr, valid, lt)
    for f in r_k._fields:
        assert torch.equal(getattr(r_k, f), getattr(r_p, f)), f
    clean = (torch.arange(96, device=cuda) % 3 != 0) & valid
    assert r_k.found[clean].all() and (r_k.iterations[clean] == 0).all()


SURVIVOR_CASES = {
    "prefilter rows": {},
    "S=1": dict(S=1),  # one row per window: one-warp blocks
    "S=37": dict(S=37),  # a ragged last block
    "S=512 wrap lags": dict(S=512, lags=[0, 863, 864, 4320, 5183]),
    "out of range": dict(bad=True),
}


@pytest.mark.parametrize("case", list(SURVIVOR_CASES))
def test_survivor_kernel_matches_plain(setup, case):
    """Kernel B2 on the prefilter's rows, every pattern 0-7 planted: S that
    is no multiple of the rows per block, lags at the window's wrap points,
    and rows whose pos, f or p lies outside the tables (128 zeros and
    nbadsync 17). nbadsync identical, softbits within 5e-3 relative."""
    kw = SURVIVOR_CASES[case]
    _, pipe, c = setup
    _, pos_f, f_idx, p_idx = (t.clone() for t in pipe.prefilter(*pipe.scan(c))[:4])
    if "S" in kw:  # the first S rows, tiled up where S exceeds the prefilter's
        rep = -(-kw["S"] // pos_f.shape[1])
        pos_f, f_idx, p_idx = (t.repeat(1, rep)[:, : kw["S"]].contiguous()
                               for t in (pos_f, f_idx, p_idx))
    S = pos_f.shape[1]
    p_idx[:, :16] = (torch.arange(16, device=c.device, dtype=torch.int32) % 8)[:S]
    if "lags" in kw:
        pos_f[:, : len(kw["lags"])] = torch.tensor(kw["lags"], dtype=torch.int32,
                                                   device=c.device)
    bad = torch.zeros_like(pos_f, dtype=torch.bool)
    if kw.get("bad"):
        for col, (t, v) in enumerate(((pos_f, -1), (pos_f, C.WINDOW_LEN), (f_idx, -1),
                                      (f_idx, pipe.W.shape[0]), (p_idx, -1), (p_idx, 8))):
            t[:, 3 * col] = v
            bad[:, 3 * col] = True
    args = (c, pipe.W, pipe.chi, pos_f, f_idx, p_idx, pipe.demod_tables)
    sb_k, nb_k = survivor.demod_survivors_cuda(*args)
    ok = ~bad
    assert (nb_k[bad] == 17).all() and (sb_k[bad] == 0).all()
    safe = [torch.where(bad, 0, t) for t in (pos_f, f_idx, p_idx)]
    sb_p, nb_p = survivor.demod_survivors_plain(*args[:3], *safe, pipe.demod_tables)
    assert torch.equal(nb_k[ok], nb_p[ok])
    assert ((sb_k - sb_p).abs() / (sb_p.abs() + 1e-3))[ok].max().item() < 5e-3


@pytest.mark.parametrize("depth,k", [(4, 8), *((8, k) for k in range(1, 9))])
def test_demod_kernel_matches_plain(setup, depth, k):
    """Kernel B4 on the scan's grid at the default width, with lags planted
    at the window's wrap points, at depth 4 and at depth 8 (every pattern,
    the gap patterns 6 and 7 too) with 1-8 candidates per pattern: softbits
    within 5e-3 relative, nbadsync equal on >= 99.99 % of rows, and every
    unequal row has a sync softbit within 1e-3 of 0. Lags outside the window
    give 128 zeros and nbadsync 17."""
    cfg, _, c = setup
    pipe = pipeline.DecodePipeline(cfg.replace(scan_depth=depth, candidates_per_pattern=k,
                                               survivor_prefilter=0)).to(c.device)
    pos = pipe.scan(c)[0].contiguous()
    flat = pos.view(pos.shape[0], -1)
    flat[:, :6] = torch.tensor([0, 863, 864, 4320, 5183, 2591], dtype=torch.int32,
                               device=c.device)
    args = (c, pipe.W, pos, pipe.demod_tables)
    sb_k, nb_k = demod.demod_candidates_cuda(*args)
    sb_p, nb_p = demod.demod_candidates_plain(*args)
    assert ((sb_k - sb_p).abs() / (sb_p.abs() + 1e-3)).max().item() < 5e-3
    share, _, near = demod.nbadsync_agreement(*args[:3], pipe.demod_tables, nb_k, nb_p)
    assert share >= 0.9999 and near
    bad = pos.clone()
    bad.view(pos.shape[0], -1)[:, -2:] = torch.tensor([-1, C.WINDOW_LEN], dtype=torch.int32,
                                                      device=c.device)
    sb_b, nb_b = demod.demod_candidates_cuda(c, pipe.W, bad, pipe.demod_tables)
    rows = (bad != pos)
    assert (nb_b[rows] == 17).all() and (sb_b[rows] == 0).all()
    assert torch.equal(nb_b[~rows], nb_k[~rows]) and torch.equal(sb_b[~rows], sb_k[~rows])


def test_bp_kernel_matches_plain(setup):
    _, pipe, c = setup
    rng = np.random.default_rng(1)
    rows = []
    for i in range(256):
        msg = rng.integers(0, 2, 77)
        cw = ldpc_tables.encode(np.concatenate([msg, (crc.CRC_MATRIX @ msg) % 2]))
        amp = 2.0 if i % 2 else 3.0
        rows.append((2.0 * cw - 1.0) * amp + rng.normal(0, 1.0, 128))
    llr = torch.from_numpy(np.stack(rows).astype(np.float32)).to(c.device)
    valid = torch.arange(256, device=c.device) % 5 != 0
    r_k = ldpc.bp_decode_cuda(llr, valid, pipe.ldpc_tables)
    r_p = ldpc.bp_decode_plain(llr, valid, pipe.ldpc_tables)
    for f in r_k._fields:
        assert torch.equal(getattr(r_k, f), getattr(r_p, f)), f
    assert r_k.found.any()


def test_decode_to_host_threads_equal_sequential(cuda):
    """Four threads, each on its own CUDA stream, decode different batches of
    8 windows at once: every leaf equals the sequential call's."""
    demo = stimulus.stream_windows(np.fromfile(DEMO, dtype=np.int16))
    batches = [demo[i:i + 8] for i in (0, 6, 12, 18)]
    dec = StreamDecoder(DecoderConfig(), cuda)
    want = [dec.decode_to_host(b) for b in batches]
    kernels.reset_launch_counts()
    with ThreadPoolExecutor(max_workers=4) as pool:
        for _ in range(3):
            got = list(pool.map(dec.decode_to_host, batches))
            for w, g in zip(want, got):
                for f in w._fields:
                    np.testing.assert_array_equal(getattr(g, f), getattr(w, f), err_msg=f)
    counts = kernels.launch_counts()
    assert counts["scan"] == counts["survivor"] == counts["bp"] == 12


def mesh_summary(md, res):
    """Per window: message -> the lowest (num_avg, nbadsync, f0) of its
    found rows (the row the CLI prints)."""
    out = []
    hashes = msg77.CallsignHashTable()
    for b in range(res.found.shape[0]):
        best = {}
        for k in np.nonzero(res.found[b])[0]:
            ok, text = msg77.unpack77(pipeline.unpack_message_bits(res.message_bits[b][k]),
                                      hashes)
            if ok:
                fi, pi, _ = md.unpack_candidate_index(int(res.cand_index[b][k]))
                key = (int(C.PATTERN_NUM_AVG[pi]), int(res.nbadsync[b][k]), float(md.freqs[fi]))
                best[text] = min(best.get(text, key), key)
        out.append(best)
    return out


@pytest.mark.parametrize("prefilter", [None, 0])
@pytest.mark.parametrize("n_time,n_freq", [(1, 4), (2, 2)])
def test_mesh_decoder_on_one_card_equals_cpu(cuda, n_time, n_freq, prefilter):
    cfg = DecoderConfig(survivor_prefilter=prefilter)
    raw = stimulus.stream_windows(np.fromfile(DEMO, dtype=np.int16))[8:12]
    n = n_time * n_freq
    md_gpu = MeshDecoder(cfg, make_mesh(n_time, n_freq, [cuda] * n))
    md_cpu = MeshDecoder(cfg, make_mesh(n_time, n_freq, ["cpu"] * n))
    kernels.reset_launch_counts()
    got = md_gpu.decode(raw)
    counts = kernels.launch_counts()
    want = md_cpu.decode(raw)
    assert mesh_summary(md_gpu, got) == mesh_summary(md_cpu, want)
    assert any(mesh_summary(md_gpu, got))
    # the all-frames pattern's scan lags tie by construction (ROADMAP C)
    assert (np.abs(got.num_survivors - want.num_survivors) <= 0.01 * want.num_survivors).all()
    demod_kernel = "survivor" if prefilter is None else "demod"
    assert counts["scan"] == counts[demod_kernel] == counts["bp"] == n


@pytest.mark.parametrize("kw,n_win", [
    (dict(), 64),  # the main path's batch
    (DEEP, 64),  # the deep scan's batch
    (dict(scan_depth=8, candidates_per_pattern=5), 16),  # the gap patterns
    (dict(), 1),  # one window: one frequency per block
    (dict(scan_decimation=2), 8),
    (dict(scan_decimation=1), 8),  # two 16-bit loads per operand register
    (dict(search_width=12.0), 64),  # F = 7: a ragged tile, mma columns unused
    (dict(search_width=0.0), 64),  # F = 1
])
def test_scan_fast_kernel_matches_fast_plain(cuda, kw, n_win):
    """Kernel B1's bf16 instantiation (the correlation on the tensor cores)
    against scan_plain(fast) by check_scan's rule: xb within 1e-4,
    positions equal but for near ties and the patterns that tie by
    construction (both sum the same exact products, in another order)."""
    pipe, c = demo_batch(cuda, DecoderConfig(**kw, fast_math=True), n_win)
    hw.check_scan(pipe, c)


@pytest.mark.parametrize("n_win,plant", [(64, False), (16, True), (4, True)])
def test_survivor_fast_kernel_matches_fast_plain(cuda, n_win, plant):
    """Kernel B2's bf16 instantiation against demod_survivors_plain(fast) on
    the prefilter's rows, with wrap lags and gap patterns planted: softbits
    within 5e-3 relative, nbadsync unequal only where a plain sync softbit
    lies within one bf16 ulp of 0."""
    pipe, c = demo_batch(cuda, DecoderConfig(fast_math=True), n_win)
    hw.check_survivor(pipe, c, plant)


@pytest.mark.parametrize("case", ["S=1", "S=37", "S=512 wrap lags"])
def test_survivor_fast_kernel_ragged_and_wrapped_rows(setup, case):
    """Kernel B2's bf16 instantiation (three blocks per SM, its matched
    filter on the tensor cores) on one-warp blocks, a ragged last block and
    lags at the window's wrap points, every pattern 0-7 planted, against
    demod_survivors_plain(fast) by check_survivor's fast rule: softbits
    within 5e-3 relative, nbadsync unequal only where a plain sync softbit
    lies within one bf16 ulp of 0."""
    kw = SURVIVOR_CASES[case]
    _, pipe, c = setup
    pipe = pipeline.DecodePipeline(DecoderConfig(fast_math=True)).to(c.device)
    _, pos_f, f_idx, p_idx = (t.clone() for t in pipe.prefilter(*pipe.scan(c))[:4])
    rep = -(-kw["S"] // pos_f.shape[1])
    pos_f, f_idx, p_idx = (t.repeat(1, rep)[:, : kw["S"]].contiguous()
                           for t in (pos_f, f_idx, p_idx))
    p_idx[:, :16] = (torch.arange(16, device=c.device, dtype=torch.int32) % 8)[: kw["S"]]
    if "lags" in kw:
        pos_f[:, : len(kw["lags"])] = torch.tensor(kw["lags"], dtype=torch.int32,
                                                   device=c.device)
    args = (c, pipe.W, pipe.chi, pos_f, f_idx, p_idx, pipe.demod_tables, True)
    sb_k, nb_k = survivor.demod_survivors_cuda(*args)
    sb_p, nb_p = survivor.demod_survivors_plain(*args)
    _, near = survivor.nbadsync_agreement(*args[:7], nb_k, nb_p, hw.NEAR_FAST, True)
    assert near and torch.isfinite(sb_k).all()
    assert ((sb_k - sb_p).abs() / (sb_p.abs() + 1e-3)).max().item() < 5e-3


@pytest.mark.parametrize("case", [0, 1])
def test_bp_fast_kernel_matches_fast_plain(cuda, case):
    """Kernel B3's bf16 instantiation against bp_decode_plain(fast) on the
    fast main path's rows of 64 windows and on planted rows: found and
    codeword identical on every row."""
    tag, llr, valid, lt = hw.bp_inputs(np.random.default_rng(case), cuda, fast=True)[case]
    hw.check_bp(tag, llr, valid, lt, fast=True)


@pytest.mark.parametrize("kw,n_win", [
    (dict(), 8),
    (dict(scan_depth=8, candidates_per_pattern=5), 2),
    (DEEP, 2),
])
def test_demod_fast_kernel_matches_fast_plain(cuda, kw, n_win):
    """Kernel B4's bf16 instantiation against demod_candidates_plain(fast)
    on every candidate, lags planted at the wrap points: softbits within
    5e-3 relative, nbadsync equal on >= 99.99 % of rows and unequal only
    where a plain sync softbit lies within one bf16 ulp of 0."""
    cfg = DecoderConfig(**kw, fast_math=True, survivor_prefilter=0)
    pipe, c = demo_batch(cuda, cfg, n_win)
    hw.check_demod(pipe, c)


def test_fast_kernels_reject_out_of_range_rows(setup):
    """The bf16 instantiations of B2 and B4 give 128 zeros and nbadsync 17
    for a row whose pos, f or p lies outside the tables."""
    _, pipe, c = setup
    _, pos_f, f_idx, p_idx = (t.clone() for t in pipe.prefilter(*pipe.scan(c))[:4])
    pos_f[:, 0], f_idx[:, 1], p_idx[:, 2] = C.WINDOW_LEN, pipe.W.shape[0], 8
    sb, nb = survivor.demod_survivors_cuda(c, pipe.W, pipe.chi, pos_f, f_idx, p_idx,
                                           pipe.demod_tables, True)
    assert (nb[:, :3] == 17).all() and (sb[:, :3] == 0).all() and (nb[:, 3:] < 17).all()
    pos = pipe.scan(c)[0].contiguous()
    pos.view(pos.shape[0], -1)[:, :2] = torch.tensor([-1, C.WINDOW_LEN], dtype=torch.int32,
                                                     device=c.device)
    sb, nb = demod.demod_candidates_cuda(c, pipe.W, pos, pipe.demod_tables, True)
    flat_sb, flat_nb = sb.view(pos.shape[0], -1, 128), nb.view(pos.shape[0], -1)
    assert (flat_nb[:, :2] == 17).all() and (flat_sb[:, :2] == 0).all()


@pytest.mark.parametrize("prefilter", [None, 0])
def test_fast_pass_launches_only_fast_kernels(cuda, prefilter):
    """A decode in fast mode launches only the fast instantiations of its
    path's kernels, one in float32 only the float32 ones."""
    demo = stimulus.stream_windows(np.fromfile(DEMO, dtype=np.int16))[:8]
    for fast in (False, True):
        cfg = DecoderConfig(survivor_prefilter=prefilter, fast_math=fast)
        dec = StreamDecoder(cfg, cuda)
        kernels.reset_launch_counts()
        dec.decode_to_host(demo)
        launched = {k for k, n in kernels.launch_counts().items() if n}
        assert launched == hw.path_kernels(cfg), (fast, launched)


# ---- CUDA graphs (ops/graphs.py) ---------------------------------------------

@pytest.mark.parametrize("n_win", [1, 64])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("prefilter", [None, 0])
def test_graph_equals_eager_bit_for_bit(cuda, prefilter, fast, n_win):
    """The capture call and replays on two different inputs, in turn, equal
    the eager forward bit for bit in every field, on the prefilter and the
    full paths, in both precisions; each replay launches one eager pass's
    kernels."""
    cfg = DecoderConfig(survivor_prefilter=prefilter, fast_math=fast)
    windows = stimulus.stream_windows(np.fromfile(DEMO, dtype=np.int16))
    batches = hw.graph_inputs(windows, n_win, np.random.default_rng(3))
    rec, graphed = hw.graph_parity(cfg, batches, cuda)
    assert rec["replays"] == 3 and len(graphed.graphs) == 1
    assert sum(rec["launches_per_replay"].values()) == 3


def test_two_submits_in_flight_are_distinct(cuda):
    """The window-by-window CLI submits window n+1 before it collects window
    n: two in-flight results of one graph hold their own buffers and equal
    the eager pipeline's."""
    windows = stimulus.stream_windows(np.fromfile(DEMO, dtype=np.int16))
    dec = StreamDecoder(DecoderConfig(), cuda)
    dec.decode_block(windows[0])  # the capture
    dec.submit(windows[2])
    dec.submit(windows[10])
    a, b = dec._pending
    assert a.buf.data_ptr() != b.buf.data_ptr()
    for w, res in ((windows[2], a), (windows[10], b)):
        want = dec.pipeline(torch.from_numpy(w[None, :]).to(cuda))
        for f, x, y in zip(want._fields, res.unpack(), want):
            assert torch.equal(x, y), f
    dec.collect()
    dec.collect()
    assert dec.in_flight == 0


def test_decode_to_host_threads_replay_their_own_graphs(cuda):
    """decode_to_host from four threads at the CLI's depth 4: each thread's
    stream captures its own graph, and every batch's result equals the
    sequential decode's."""
    demo = stimulus.stream_windows(np.fromfile(DEMO, dtype=np.int16))
    batches = [demo[i:i + 16] for i in (0, 3, 6, 9)]
    dec = StreamDecoder(DecoderConfig(survivor_prefilter=0), cuda)
    want = [dec.decode_to_host(b) for b in batches]
    with ThreadPoolExecutor(max_workers=4) as pool:
        for _ in range(3):
            got = list(pool.map(dec.decode_to_host, batches * 2))
            for w, g in zip(want * 2, got):
                for f in w._fields:
                    np.testing.assert_array_equal(getattr(g, f), getattr(w, f), err_msg=f)
    assert 2 <= len(dec.graphed.graphs) <= 5  # the main thread's and each worker's


def test_pass_spans_tell_a_capture_from_a_launch(cuda, monkeypatch):
    """With tracing on, a pass's span is `graph_capture` exactly where the
    pass captured a new graph (the decoder's graphs grew by one) and
    `launch` elsewhere: decode_block on the current stream, decode_to_host
    on the main thread's and a worker's own stream, a new batch shape, and
    new streams on handles that already have their graph."""
    import contextlib
    import io

    from msk144cudecoder_tpu_torch.runtime import metrics

    demo = stimulus.stream_windows(np.fromfile(DEMO, dtype=np.int16))
    dec = StreamDecoder(DecoderConfig(), cuda)
    graphed = dec.graphed
    monkeypatch.setenv(metrics.ENV, "1")
    metrics.refresh()

    def labels():
        a = metrics.recorder().aggregates
        return [a[n].count if n in a else 0 for n in ("graph_capture", "launch")]

    def grew(fn) -> int:
        n0, (c0, l0) = len(graphed.graphs), labels()
        fn()
        n1, (c1, l1) = len(graphed.graphs), labels()
        assert (c1 - c0, l1 - l0) == (n1 - n0, 1 - (n1 - n0)), (n0, n1, c0, c1, l0, l1)
        return n1 - n0

    try:
        with contextlib.redirect_stderr(io.StringIO()):
            assert [grew(lambda: dec.decode_block(demo[i])) for i in range(3)] == [1, 0, 0]
            assert [grew(lambda: dec.decode_to_host(demo[:8])) for _ in range(2)] == [1, 0]
            with ThreadPoolExecutor(max_workers=1) as pool:
                assert [pool.submit(grew, lambda: dec.decode_to_host(demo[:8])).result()
                        for _ in range(2)] == [1, 0]
            assert [grew(lambda: dec.decode_to_host(demo[:4])) for _ in range(2)] == [1, 0]
            # a new thread each pass: new streams, whose handles the pool hands out again
            fresh = []
            for _ in range(72):
                with ThreadPoolExecutor(max_workers=1) as pool:
                    fresh.append(pool.submit(grew, lambda: dec.decode_to_host(demo[:2])).result())
            assert fresh[0] == 1 and 0 in fresh, fresh
    finally:
        monkeypatch.setenv(metrics.ENV, "0")
        metrics.refresh()


def test_mesh_decoder_replays_graphs(cuda):
    """MeshDecoder (2, 2) on one card through its shards' graphs: repeated
    decodes equal the CPU mesh's summary, and each shard holds one graph."""
    cfg = DecoderConfig()
    raw = stimulus.stream_windows(np.fromfile(DEMO, dtype=np.int16))[8:12]
    md_gpu = MeshDecoder(cfg, make_mesh(2, 2, [cuda] * 4))
    want = mesh_summary(md_gpu, MeshDecoder(cfg, make_mesh(2, 2, ["cpu"] * 4)).decode(raw))
    for _ in range(3):
        assert mesh_summary(md_gpu, md_gpu.decode(raw)) == want
    assert all(len(run.__self__.graphs) == 1 for run in md_gpu._runs.flat)


@pytest.mark.parametrize("prefilter", [None, 0])
def test_launch_counts_per_pass_under_replay(cuda, prefilter):
    """A StreamDecoder pass over the demo counts one launch per kernel per
    window, the capture included: replays add what the capture recorded."""
    windows = stimulus.stream_windows(np.fromfile(DEMO, dtype=np.int16))
    cfg = DecoderConfig(survivor_prefilter=prefilter)
    dec = StreamDecoder(cfg, cuda)
    kernels.reset_launch_counts()
    for w in windows:
        dec.decode_block(w)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert {k: n for k, n in counts.items() if n} == {k: len(windows)
                                                      for k in hw.path_kernels(cfg)}
