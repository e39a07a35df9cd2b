"""The fast_math precision mode on the CPU: the port's fast plain versions of
kernels B1-B4, and the whole slice, against the JAX package's own fast
Pallas kernels.

The JAX kernels take their fast mode only when their launcher is called
with interpret=False and fast_math=True. `jax_fast()` wraps
jax.experimental.pallas.pallas_call to force interpret=True, so that the
real kernels, rounding points and all, run in the interpreter on the CPU.
Two roundings of the TPU are not reproduced there, since XLA on the CPU
computes a dot at Precision.DEFAULT on float32 operands in full float32: B2's
per-frequency table fetch (msk144cudecoder_tpu/ops/pallas_survivor.py:195-197)
and B4's matched filter (ops/pallas_demod.py:159-160). `jax_fast()` applies
them on the JAX side, as the TPU computes such a dot in one bf16 pass: it
wraps jnp.matmul (which survivor_params calls) and pallas_demod._dot_mf so
that both operands of a DEFAULT dot are rounded to bf16 first. Nothing in
the JAX package changes.

Tolerances, each against JAX's fast kernel, with JAX's exact output (the
same kernel interpreted in float32, or the jnp path) as the yardstick the
port's fast output must beat by median row error:
  B1  xb within 2e-5 relative (the Pallas kernel keeps |s|^2 as packed keys
      with the in-slice lag in the low mantissa bits, <= 2^-17 relative on
      xb, and sums in another order); positions equal on >= 99 % of the
      slots of every pattern but 5, unequal ones near ties only. Against
      the Pallas kernel the gap pattern 6 = {0, 3} is exempt too: its
      metric repeats every N/2 lags, so its slice maxima tie by
      construction, and the packed keys break those ties by lag where the
      port takes the smaller slice.
  B2  nbadsync identical; softbits within 1e-5 row-relative L2 (the port
      derotates each bf16 sample before the taps, the JAX kernel the
      filter's float32 outputs: the same linear map).
  B3  found, codeword, iterations and hard errors identical on every row.
  B4  softbits within 1e-6 row-relative L2 by median and 1e-3 at most (a
      float32 pattern sum taken in another order can round one sample to
      the neighbouring bf16 value); nbadsync identical on >= 99.9 % of rows.
The fast plain versions must also differ from the float32 ones (the
rounding happened: at least 1e-4 row-relative), and decode what the float32
path decodes on the demo capture.
"""

import contextlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jpl

from msk144cudecoder_tpu import golden as G
from msk144cudecoder_tpu.config import DecoderConfig as JaxConfig
from msk144cudecoder_tpu.ops import pallas_demod, pallas_ldpc, pallas_scan, pallas_survivor
from msk144cudecoder_tpu.ops import pipeline as jpipeline
from msk144cudecoder_tpu.ops import softbits as jsoftbits
from msk144cudecoder_tpu.protocol import crc as jcrc
from msk144cudecoder_tpu.protocol import ldpc_tables as jldpc_tables
from msk144cudecoder_tpu_torch import cli, stimulus
from msk144cudecoder_tpu_torch import constants as C
from msk144cudecoder_tpu_torch.config import DecoderConfig
from msk144cudecoder_tpu_torch.ops import demod, kernels, ldpc, pipeline, precision, scan, survivor
from msk144cudecoder_tpu_torch.ops import tables
from msk144cudecoder_tpu_torch.protocol import msg77
from msk144cudecoder_tpu_torch.tools import sensitivity_sweep

torch.set_num_threads(2)
FREQS = tuple(float(f) for f in np.arange(1450.0, 1551.0, 2.0))  # F = 51
DEMO = pathlib.Path(__file__).resolve().parents[1] / "demo" / "capture.raw"


@contextlib.contextmanager
def jax_fast():
    """The JAX kernels' fast mode on the CPU: pallas_call interpreted, and
    a dot at Precision.DEFAULT on float32 operands rounded as the TPU's one
    bf16 pass (see the module docstring)."""
    orig_call, orig_matmul, orig_mf = jpl.pallas_call, jnp.matmul, pallas_demod._dot_mf

    def pallas_call(*args, **kw):
        kw["interpret"] = True
        return orig_call(*args, **kw)

    def bf16(x):
        return x.astype(jnp.bfloat16).astype(jnp.float32)

    def matmul(a, b, *, precision=None, **kw):
        if precision == jax.lax.Precision.DEFAULT:
            a, b, precision = bf16(a), bf16(b), jax.lax.Precision.HIGHEST
        return orig_matmul(a, b, precision=precision, **kw)

    def dot_mf(ch, m_f32, m_h, m_l, mode):
        if mode == "fast":
            return jnp.dot(bf16(ch), bf16(m_f32), preferred_element_type=jnp.float32,
                           precision=jax.lax.Precision.HIGHEST)
        return orig_mf(ch, m_f32, m_h, m_l, mode)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpl, "pallas_call", pallas_call)
        mp.setattr(jnp, "matmul", matmul)
        mp.setattr(pallas_demod, "_dot_mf", dot_mf)
        yield


def row_err(a, ref) -> np.ndarray:
    """Row-relative L2 error of a against ref, rows on the first axis."""
    a = np.asarray(a, np.float64).reshape(len(a), -1)
    ref = np.asarray(ref, np.float64).reshape(len(ref), -1)
    return np.linalg.norm(a - ref, axis=1) / np.maximum(np.linalg.norm(ref, axis=1), 1e-30)


@pytest.fixture(scope="module")
def window():
    a = G.synthesize_audio_int16([("CQ K1ABC FN42", 1505.0)], 6, snr_db=6.0,
                                 rng=np.random.default_rng(7))
    return G.analytic_method2(G.rms_normalize_int16(a)).astype(np.complex64)


@pytest.fixture(scope="module")
def tabs():
    tt = tables.to_torch(tables.build_freq_tables(np.asarray(FREQS)), "cpu")
    return tt, tables.demod_to_torch("cpu")


def port_scan(window, tabs, depth, dec, fast):
    tt, _ = tabs
    pos, xb = scan.scan_plain(torch.from_numpy(window)[None], tt.B,
                              tables.e_decimated(tt.E, dec), tt.chi, depth, 8, dec, fast)
    return pos[0].numpy(), xb[0].numpy()


def test_round_bf16_is_round_to_nearest_even():
    """round_bf16 against the bit rule: add 0x7fff plus the kept LSB, drop
    the low 16 bits (finite values)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(0, 1, 4096) * 10.0 ** rng.integers(-8, 8, 4096),
                        [1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 0.0]]).astype(np.float32)
    u = x.view(np.uint32).astype(np.uint64)
    want = (((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16).astype(np.uint32).view(np.float32)
    np.testing.assert_array_equal(precision.round_bf16(torch.from_numpy(x)).numpy(), want)
    assert precision.round_bf16(torch.tensor([1 + 2 ** -8])).item() == 1.0  # a tie goes to even


@pytest.mark.parametrize("depth", [4, 8])
def test_scan_fast_matches_jax_fast_kernel(window, tabs, depth):
    """B1: scan_plain(fast) against pallas_scan.scan_pallas in its fast mode
    (the main path's dec 4; depth 8 holds the gap patterns)."""
    with jax_fast():
        pos_j, xb_j = pallas_scan.scan_pallas(jnp.asarray(window), FREQS, depth,
                                              interpret=False, fast_math=True, dec=4)
    pos_e, xb_e = pallas_scan.scan_pallas(jnp.asarray(window), FREQS, depth, interpret=True, dec=4)
    pos_j, xb_j, pos_e, xb_e = map(np.asarray, (pos_j, xb_j, pos_e, xb_e))
    pos_p, xb_p = port_scan(window, tabs, depth, 4, True)
    _, xb_0 = port_scan(window, tabs, depth, 4, False)
    rel = np.abs(xb_p - xb_j) / xb_j
    assert rel.max() <= 2e-5, rel.max()
    mism = pos_p != pos_j
    for p in range(depth):
        if p not in (5, 6):  # structural ties (module docstring)
            assert mism[:, p].mean() <= 0.01, (p, mism[:, p].mean())
    assert (rel[mism] <= 1e-4).all()
    # closer to JAX's fast kernel than JAX's exact kernel is, and rounded
    assert np.median(rel) < np.median(np.abs(xb_e - xb_j) / xb_j)
    assert np.max(np.abs(xb_p - xb_0) / xb_0) >= 1e-4


@pytest.fixture(scope="module")
def survivor_rows(window, tabs):
    """128 rows: the best scan candidates by xb, the first six replaced by
    lags at the window's wrap points with the gap and all-frames patterns."""
    pos, xb = port_scan(window, tabs, 4, 4, False)
    flat = np.argsort(-xb.reshape(-1), kind="stable")[:128]
    pos_s = pos.reshape(-1)[flat].astype(np.int32)
    f_idx = (flat // 32).astype(np.int32)
    p_idx = ((flat % 32) // 8).astype(np.int32)
    pos_s[:6] = [5000, 5183, 0, 4321, 2591, 863]
    p_idx[:6] = [7, 6, 5, 3, 1, 0]
    return pos_s, f_idx, p_idx


def test_survivor_fast_matches_jax_fast_kernel(window, tabs, survivor_rows):
    """B2: demod_survivors_plain(fast) against pallas_survivor.demod_survivors
    in its fast mode (the flat six-frame layout, every row its own
    pattern)."""
    tt, dt = tabs
    args = [jnp.asarray(a) for a in survivor_rows]
    with jax_fast():
        sb_j, nb_j = pallas_survivor.demod_survivors(jnp.asarray(window), FREQS, *args,
                                                     interpret=False, fast_math=True, sb_blk=128)
    sb_e, _ = pallas_survivor.demod_survivors(jnp.asarray(window), FREQS, *args,
                                              interpret=True, sb_blk=128)
    rows = [torch.from_numpy(a)[None] for a in survivor_rows]
    c = torch.from_numpy(window)[None]
    sb_p, nb_p = survivor.demod_survivors_plain(c, tt.W, tt.chi, *rows, dt, fast=True)
    sb_0, _ = survivor.demod_survivors_plain(c, tt.W, tt.chi, *rows, dt)
    np.testing.assert_array_equal(nb_p[0].numpy(), np.asarray(nb_j))
    err = row_err(sb_p[0], sb_j)
    assert err.max() <= 1e-5, err.max()
    assert np.median(err) < np.median(row_err(sb_e, sb_j))
    assert np.median(row_err(sb_p[0], sb_0[0])) >= 1e-4


def planted_llr(n: int, seed: int) -> np.ndarray:
    """n rows of codewords at amplitudes 1.2-2.2 in unit noise: around BP's
    threshold, so that many rows take several iterations."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        msg = rng.integers(0, 2, 77)
        cw = jldpc_tables.encode(np.concatenate([msg, (jcrc.CRC_MATRIX @ msg) % 2]))
        rows.append((2.0 * cw - 1.0) * rng.uniform(1.2, 2.2) + rng.normal(0, 1.0, 128))
    return np.stack(rows).astype(np.float32)


def test_bp_fast_matches_jax_fast_kernel():
    """B3: bp_decode_plain(fast) against pallas_ldpc.bp_decode_pallas in its
    fast mode: every output identical on every row; JAX's exact kernel
    differs from its fast one on some row, and so does the port's float32."""
    n = 1024
    llr, valid = planted_llr(n, 5), np.ones(n, bool)
    with jax_fast():
        r_j = pallas_ldpc.bp_decode_pallas(jnp.asarray(llr), jnp.asarray(valid),
                                           interpret=False, fast_math=True)
    r_e = pallas_ldpc.bp_decode_pallas(jnp.asarray(llr), jnp.asarray(valid), interpret=True)
    lt = tables.ldpc_to_torch("cpu")
    r_p = ldpc.bp_decode_plain(torch.from_numpy(llr), torch.from_numpy(valid), lt, fast=True)
    r_0 = ldpc.bp_decode_plain(torch.from_numpy(llr), torch.from_numpy(valid), lt)

    def unequal(r, ref):
        return sum(int((np.asarray(getattr(r, f)).reshape(n, -1)
                        != np.asarray(getattr(ref, f)).reshape(n, -1)).any(axis=1).sum())
                   for f in ("found", "codeword", "iterations", "hard_errors"))

    assert unequal(r_p, r_j) == 0
    assert unequal(r_e, r_j) > 0 and unequal(r_0, r_p) > 0
    assert 150 < int(r_p.found.sum()) < 400  # decodes, and not every row
    assert int((r_p.iterations[r_p.found] >= 3).sum()) > 50  # the messages matter


@pytest.mark.parametrize("depth", [4, 8])
def test_demod_fast_matches_jax_fast_kernel(window, tabs, depth):
    """B4: demod_candidates_plain(fast) against pallas_demod.demod_pallas in
    its fast mode on the scan's grid (F = 51, depth 4 or 8, k = 8), lags
    planted at the window's wrap points (depth 8: also in the gap patterns
    6 = {0, 3} and 7 = 6 + {4}); JAX's exact yardstick is its jnp demod."""
    tt, dt = tabs
    pos, _ = port_scan(window, tabs, depth, 4, False)
    wraps = [0, 863, 864, 4320, 5183, 2591]
    pos.reshape(-1)[:6] = wraps
    if depth == 8:
        pos[0, 6:, :6] = wraps
    with jax_fast():
        sb_j, nb_j = pallas_demod.demod_pallas(jnp.asarray(window), FREQS, jnp.asarray(pos),
                                               interpret=False, fast_math=True)
    sb_e, _ = jsoftbits.demod_candidates(jnp.asarray(window), FREQS, depth, jnp.asarray(pos))
    c, p = torch.from_numpy(window)[None], torch.from_numpy(pos)[None]
    sb_p, nb_p = demod.demod_candidates_plain(c, tt.W, p, dt, fast=True)
    sb_0, _ = demod.demod_candidates_plain(c, tt.W, p, dt)
    sb_j, sb_e = np.asarray(sb_j).reshape(-1, 128), np.asarray(sb_e).reshape(-1, 128)
    err = row_err(sb_p.reshape(-1, 128), sb_j)
    assert np.median(err) <= 1e-6 and err.max() <= 1e-3, (np.median(err), err.max())
    assert (nb_p.numpy().reshape(-1) == np.asarray(nb_j).reshape(-1)).mean() >= 0.999
    assert np.median(err) < np.median(row_err(sb_e, sb_j))
    assert np.median(row_err(sb_p.reshape(-1, 128), sb_0.reshape(-1, 128))) >= 1e-4


def test_slice_fast_matches_jax_fast_kernels():
    """The whole slice: DecodePipeline(fast_math=True) on the CPU against the
    JAX decode_windows on its kernel branch in fast mode (scan_pallas,
    the tiered demod_survivors, bp_decode_pallas), on the same analytic
    windows (a 0 dB ping and noise): the found rows' candidates, nbadsync,
    lags and payloads are identical, and the survivor counts within one row.
    Their xb agree within 1e-3 relative: B1's test holds the scan's xb to
    2e-5, but decode_windows, measured here on the CPU, reports the found
    rows' xb about 3e-4 relative off its own scan kernel's output (its glue
    moves xb through one-hot matmuls)."""
    kw = dict(search_width=100.0, scan_depth=4, max_survivors=128)
    rng = np.random.default_rng(9)
    raw = np.stack([G.synthesize_audio_int16([("K1ABC W9XYZ EN37", 1496.0)], 6, snr_db=0.0,
                                             rng=rng),
                    rng.normal(0, 1000, 5184).astype(np.int16)])
    jcfg = JaxConfig(**kw, use_pallas=True, fast_math=True)
    c = np.asarray(jpipeline.preprocess(jnp.asarray(raw), jcfg))
    with jax_fast():
        ref = jpipeline.decode_windows(jnp.asarray(c), tuple(float(f) for f in jcfg.freqs), jcfg)
    pipe = pipeline.DecodePipeline(DecoderConfig(**kw, fast_math=True))
    ct = torch.from_numpy(c.copy())
    front = pipe.prefilter(*pipe.scan(ct))
    prep = pipe.select(*pipe.demod(ct, front), front)
    ours = pipe.finish(prep, pipe.bp(prep), ct)
    found = np.asarray(ref.found)
    np.testing.assert_array_equal(ours.found.numpy(), found)
    assert found[0].sum() >= 4 and not found[1].any()
    for f in ("cand_index", "nbadsync", "pos", "message_bits"):
        np.testing.assert_array_equal(getattr(ours, f).numpy()[found], np.asarray(getattr(ref, f))[found])
    xb = np.asarray(ref.xb)[found]
    assert (np.abs(ours.xb.numpy()[found] - xb) <= 1e-3 * xb).all()
    assert (np.abs(ours.num_survivors.numpy() - np.asarray(ref.num_survivors)) <= 1).all()
    hashes = msg77.CallsignHashTable()
    texts = {msg77.unpack77(pipeline.unpack_message_bits(ours.message_bits[0][k].numpy()), hashes)[1]
             for k in np.nonzero(found[0])[0]}
    assert texts == {"K1ABC W9XYZ EN37"}


def demo_summary(cfg) -> list[dict]:
    """Per demo window: message -> the lowest (num_avg, nbadsync) of its
    found rows, by DecodePipeline on the CPU."""
    windows = stimulus.stream_windows(np.fromfile(DEMO, dtype=np.int16))
    pipe = pipeline.DecodePipeline(cfg)
    hashes = msg77.CallsignHashTable()
    out = []
    for lo in range(0, len(windows), 4):
        res = pipe(torch.from_numpy(windows[lo:lo + 4]))
        for b in range(res.found.shape[0]):
            best = {}
            for k in np.nonzero(res.found[b].numpy())[0]:
                ok, text = msg77.unpack77(
                    pipeline.unpack_message_bits(res.message_bits[b][k].numpy()), hashes)
                if ok:
                    _, pi, _ = pipeline.unpack_candidate_index(cfg, int(res.cand_index[b][k]))
                    key = (int(C.PATTERN_NUM_AVG[pi]), int(res.nbadsync[b][k]))
                    best[text] = min(best.get(text, key), key)
            out.append(best)
    return out


@pytest.mark.parametrize("prefilter", [None, 0])
def test_fast_plain_path_decodes_the_demo_as_fp32(prefilter):
    """On the demo capture (three strong messages), the fast plain path
    decodes, window by window, the messages of the float32 path at the same
    (num_avg, nbadsync): through B2's plain version with the prefilter on,
    through B4's with it off."""
    cfg = DecoderConfig(survivor_prefilter=prefilter)
    fast, exact = demo_summary(cfg.replace(fast_math=True)), demo_summary(cfg)
    assert fast == exact
    assert set().union(*fast) == {"CQ K1ABC FN42", "K1ABC W9XYZ EN37", "W9XYZ K1ABC RR73"}


def test_config_default_is_fp32_and_the_cli_keeps_it():
    assert DecoderConfig().fast_math is False
    for argv in ([], ["--exact-math"]):
        assert cli.config_from_args(cli.build_parser().parse_args(argv)).fast_math is False


@pytest.mark.parametrize("fast,line", [(False, "Precision: fp32"),
                                       (True, "Precision: bf16 inputs, f32 accumulation")])
def test_banner_names_the_precision(capsys, fast, line):
    cli.print_banner(DecoderConfig(fast_math=fast), "cpu")
    assert line in capsys.readouterr().err.splitlines()


def test_launch_counts_keep_fast_apart():
    kernels.reset_launch_counts()
    kernels.count_launch(scan.scan_cuda, True)
    kernels.count_launch(ldpc.bp_decode_cuda)
    counts = kernels.launch_counts()
    assert counts == {"scan": 0, "survivor": 0, "demod": 0, "bp": 1,
                      "scan_fast": 1, "survivor_fast": 0, "demod_fast": 0, "bp_fast": 0}
    kernels.reset_launch_counts()
    assert not any(kernels.launch_counts().values())


@pytest.mark.parametrize("prefilter,demod_op", [(None, "survivor"), (0, "demod")])
@pytest.mark.parametrize("fast", [False, True])
def test_pipeline_passes_the_precision_to_every_kernel(monkeypatch, prefilter, demod_op, fast):
    """cfg.fast_math reaches the scan, the demod of either path and BP."""
    seen = {}

    def spy(name, mod, attr):
        orig = getattr(mod, attr)

        def wrapped(*args, **kw):
            seen[name] = kw.get("fast", args[-1] if isinstance(args[-1], bool) else None)
            return orig(*args, **kw)

        monkeypatch.setattr(mod, attr, wrapped)

    spy("scan", scan, "scan")
    spy("survivor", survivor, "demod_survivors")
    spy("demod", demod, "demod_candidates")
    spy("bp", ldpc, "bp_decode")
    cfg = DecoderConfig(search_width=20.0, scan_depth=2, max_survivors=16,
                        survivor_prefilter=prefilter, fast_math=fast)
    raw = np.random.default_rng(1).normal(0, 1000, (1, 5184)).astype(np.int16)
    pipeline.DecodePipeline(cfg)(torch.from_numpy(raw))
    assert seen == {"scan": fast, demod_op: fast, "bp": fast}


def test_sweep_cli_fast_math(capsys):
    """--fast-math runs the sweep in the bf16 mode (two trials at 0 dB,
    width 20, on the CPU's fast plain path) and says so."""
    assert sensitivity_sweep.main(["--device=cpu", "--fast-math", "--trials", "2",
                                   "--search-width", "20", "--snrs", "0"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].endswith("precision=bf16"), out[0]
    assert "2/2" in out[2], out
