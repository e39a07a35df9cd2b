"""The PyTorch port's survivor demod (plain version of kernel B2) against the
JAX package's pallas_survivor.demod_survivors_ref and the Pallas kernel in
interpret mode, on the CPU, including frames that wrap the window and the
gap patterns 6 and 7.

Tolerance, the bound tests/test_survivor.py uses: nbadsync identical,
softbits |d| / (|ref| + 1e-3) < 5e-3 (float32 products and sums taken in
another order)."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msk144cudecoder_tpu.constants as JC
from msk144cudecoder_tpu import golden as G
from msk144cudecoder_tpu.ops import pallas_survivor
from msk144cudecoder_tpu.ops import scan as jscan
from msk144cudecoder_tpu.ops import softbits as jsoftbits
from msk144cudecoder_tpu_torch.config import DecoderConfig
from msk144cudecoder_tpu_torch.ops import kernels, pipeline, precision, softbits, survivor, tables

torch.set_num_threads(2)
FREQS = tuple(float(f) for f in np.arange(1450.0, 1551.0, 2.0))  # F = 51
F = len(FREQS)


@pytest.fixture(scope="module")
def window():
    a = G.synthesize_audio_int16([("CQ K1ABC FN42", 1505.0)], 6, snr_db=6.0,
                                 rng=np.random.default_rng(7))
    return G.analytic_method2(G.rms_normalize_int16(a)).astype(np.complex64)


@pytest.fixture(scope="module")
def tabs():
    tt = tables.to_torch(tables.build_freq_tables(np.asarray(FREQS)), "cpu")
    return tt, tables.demod_to_torch("cpu")


@pytest.fixture(scope="module")
def candidates(window):
    """The 256 best scan candidates by xb (the prefilter's kind of rows)."""
    pos, xb = jscan.scan(jnp.asarray(window), FREQS, 6)
    nc = pos.shape[0] * pos.shape[1] * pos.shape[2]
    pre = np.argsort(-np.asarray(xb).reshape(nc), kind="stable")[:256].astype(np.int32)
    per_f = pos.shape[1] * pos.shape[2]
    return (np.asarray(pos).reshape(nc)[pre], pre // per_f, (pre % per_f) // pos.shape[2])


def port_demod(window, tabs, pos, f_idx, p_idx):
    tt, dt = tabs
    t = [torch.from_numpy(np.asarray(a, np.int32))[None] for a in (pos, f_idx, p_idx)]
    sb, nbad = survivor.demod_survivors(torch.from_numpy(window)[None], tt.W, tt.chi,
                                        *t, dt)
    return sb[0].numpy(), nbad[0].numpy()


def assert_demod_close(sb, nbad, sb_ref, nbad_ref):
    np.testing.assert_array_equal(nbad, np.asarray(nbad_ref))
    sb_ref = np.asarray(sb_ref)
    assert (np.abs(sb - sb_ref) / (np.abs(sb_ref) + 1e-3)).max() < 5e-3


def wrap_rows():
    """Rows whose frames wrap the window, over every pattern incl. 6 and 7."""
    pos = np.tile([5000, 5183, 4321, 3500], 32).astype(np.int32)
    return pos, (np.arange(128) * 7 % F).astype(np.int32), (np.arange(128) % 8).astype(np.int32)


def test_matches_ref(window, tabs, candidates):
    sb, nbad = port_demod(window, tabs, *candidates)
    ref = pallas_survivor.demod_survivors_ref(jnp.asarray(window), FREQS,
                                              *(jnp.asarray(a) for a in candidates))
    assert_demod_close(sb, nbad, *ref)


def test_matches_pallas_interpret(window, tabs, candidates):
    sb, nbad = port_demod(window, tabs, *candidates)
    ref = pallas_survivor.demod_survivors(jnp.asarray(window), FREQS,
                                          *(jnp.asarray(a) for a in candidates),
                                          interpret=True)
    assert_demod_close(sb, nbad, *ref)


def test_wrap_positions_and_gap_patterns(window, tabs):
    rows = wrap_rows()
    sb, nbad = port_demod(window, tabs, *rows)
    ref = pallas_survivor.demod_survivors_ref(jnp.asarray(window), FREQS,
                                              *(jnp.asarray(a) for a in rows))
    assert_demod_close(sb, nbad, *ref)


@pytest.mark.parametrize("p", [0, 2, 5, 6, 7])
def test_one_pattern_tier(window, tabs, candidates, p):
    """A call whose rows all carry pattern p equals the JAX tiered call for
    that pattern's active frames."""
    pos, f_idx, _ = candidates
    p_idx = np.full(16, p, np.int32)
    sb, nbad = port_demod(window, tabs, pos[:16], f_idx[:16], p_idx)
    terms = tuple(int(x) for x in np.nonzero(JC.PATTERN_MASKS[p])[0])
    ref = pallas_survivor.demod_survivors(jnp.asarray(window), FREQS, jnp.asarray(pos[:16]),
                                          jnp.asarray(f_idx[:16]), jnp.asarray(p_idx),
                                          interpret=True, sb_blk=16, terms=terms)
    assert_demod_close(sb, nbad, *ref)


def test_batched_windows_equal_single(window, tabs, candidates):
    """Two windows in one call equal two single-window calls."""
    tt, dt = tabs
    noise = np.random.default_rng(2).normal(0, 1, 5184) + 1j * np.random.default_rng(3).normal(
        0, 1, 5184)
    c = torch.from_numpy(np.stack([window, noise.astype(np.complex64)]))
    idx = [torch.from_numpy(np.stack([a, a[::-1].copy()]).astype(np.int32)) for a in candidates]
    sb, nbad = survivor.demod_survivors(c, tt.W, tt.chi, *idx, dt)
    for b in range(2):
        sb1, nb1 = survivor.demod_survivors(c[b:b + 1], tt.W, tt.chi,
                                            *(a[b:b + 1] for a in idx), dt)
        np.testing.assert_array_equal(nbad[b].numpy(), nb1[0].numpy())
        np.testing.assert_allclose(sb[b].numpy(), sb1[0].numpy(), rtol=1e-6, atol=1e-6)


def test_softbits_demod_matches_jax(tabs):
    rng = np.random.default_rng(12)
    frames = (rng.normal(0, 1, (40, 864)) + 1j * rng.normal(0, 1, (40, 864))).astype(np.complex64)
    sb, nbad = softbits.demod(torch.from_numpy(frames), tabs[1])
    sb_ref, nbad_ref = jsoftbits.demod(jnp.asarray(frames))
    assert_demod_close(sb.numpy(), nbad.numpy(), sb_ref, nbad_ref)


def test_kernel_wrapper_refuses_cpu_tensors(window, tabs, candidates):
    tt, dt = tabs
    t = [torch.from_numpy(np.asarray(a, np.int32))[None] for a in candidates]
    with pytest.raises(ValueError, match="CUDA tensor"):
        survivor.demod_survivors_cuda(torch.from_numpy(window)[None], tt.W, tt.chi, *t, dt)


@pytest.mark.parametrize("S,n_win,sms,want", [
    (512, 64, 132, 32),  # the main path's batch: 1024 blocks for 132 SMs
    (512, 16, 132, 32),  # 256 blocks
    (512, 4, 132, 8),  # 4 windows: 64 blocks of 32 rows would leave SMs idle
    (37, 64, 132, 16),  # 32 rows a block: 128 blocks; 16: 192, a ragged last one
    (37, 64, 16, 32),  # a block of 32 rows and one of 5
    (1, 64, 132, 1),  # one row per window: one-warp blocks
    (3, 64, 132, 3),  # no more rows per block than S
    (512, 1, 132, 8),
])
def test_rows_per_block(S, n_win, sms, want):
    """Kernel B2's rows per block: 32, 16 or 8 (at most S) where the grid
    still gives every SM a block, else min(S, 8); the grid covers every
    row."""
    rows = survivor.rows_per_block(S, n_win, sms)
    assert rows == want
    assert 1 <= rows <= S
    assert -(-S // rows) * rows >= S


# ---- the premises of kernel B2's bf16 tail on the tensor cores -------------
# (csrc/common.cuh mma_tail: the frame packed as bf16 pairs, the softbits'
# 12-tap sums as a matrix product, derotated after the taps)

NEAR_FAST = 2.0 ** -8  # tools/run_hwtests.NEAR_FAST: one bf16 ulp at 1


def common_const(name: str) -> int:
    src = (kernels.CSRC_DIR / "common.cuh").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


@pytest.fixture(scope="module")
def fast_rows():
    """The fast main path's survivor rows on the CPU: the prefilter's 512
    rows of a 0 dB signal window and a noise window (seeded numpy), with
    wrap lags and gap patterns planted in the first 8 rows of each, as
    run_hwtests.check_survivor plants them, and lag 0 (no wrap) beside
    them. Returns (pipeline, windows, pos, f_idx, p_idx)."""
    rng = np.random.default_rng(9)
    a = G.synthesize_audio_int16([("CQ K1ABC FN42", 1500.0)], 6, snr_db=0.0, rng=rng)
    raw = np.stack([a, rng.normal(0, 1000, a.shape[0]).astype(np.int16)])
    pipe = pipeline.DecodePipeline(DecoderConfig(fast_math=True))
    c = pipe.preprocess(torch.from_numpy(raw))
    pos, f_idx, p_idx = (t.clone() for t in pipe.prefilter(*pipe.scan(c))[1:4])
    pos[:, :9] = torch.tensor([5000, 5183, 4321, 3500, 0, 2591, 5180, 4400, 0], dtype=torch.int32)
    p_idx[:, :9] = torch.tensor([6, 7, 6, 7, 5, 3, 0, 7, 0], dtype=torch.int32)
    f_idx[:, :9] = torch.tensor([0, 100, 50, 7, 99, 1, 60, 33, 50], dtype=torch.int32)
    return pipe, c, pos, f_idx, p_idx


@pytest.fixture(scope="module")
def fast_frames(fast_rows):
    pipe, c, pos, f_idx, p_idx = fast_rows
    return survivor.survivor_frames_plain(c, pipe.W, pipe.chi, pos, f_idx, p_idx,
                                          pipe.demod_tables, fast=True)


def test_fast_frames_are_bf16(fast_frames):
    """The fast mode's frames are exactly bf16 (frame_fast rounds every
    result), so kernel B2 keeps them packed, one word a sample, losing
    nothing."""
    assert fast_frames.shape == (2, 512, 864)
    assert torch.equal(precision.round_complex(fast_frames), fast_frames)
    assert bool((fast_frames.abs() > 0).any(dim=-1).all())


def frame_word(f):
    """common.cuh frame_word: word f of the packed frame (sample f - 6, f < 6
    samples 858-863 again) after its padding of kRowPad words every
    kRowSamples."""
    return f + common_const("kRowPad") * (f // common_const("kRowSamples"))


def tail_b(pp: torch.Tensor) -> torch.Tensor:
    """mma_tail's B (64, 8) for taps pp (12,): row 2o + e, column 2m + e
    holds tap o - 6m of softbit 4j + m on part e (x, y) of sample o of row
    j, zero elsewhere."""
    B = torch.zeros(64, 8)
    for m in range(4):
        for e in range(2):
            B[2 * (6 * m + torch.arange(12)) + e, 2 * m + e] = pp
    return B


def test_packed_frame_rows_are_the_matched_filter_rows():
    """mma_tail's rows: softbit t = 4j + m reads words f = 24j + 6m + i of
    the packed frame, which are the matched filter's rows (softbits.mf_index:
    the Q rail's wrap row q = 0 reads samples 858-863 then 0-5, the last I
    row 852-863), each tap once, and never the two zero pads; B holds each
    softbit's 12 taps at its offset. Each A-fragment load (lane g, c at row
    16 mt + g or + 8, clamped to row 35, sample 8 kk + 4 i + c) stays in the
    frame's words and puts the lanes' distinct words on distinct banks."""
    lead, words, rows = (common_const(n) for n in ("kFrameLead", "kFrameWords", "kTailRows"))
    t = torch.arange(144)
    f = 24 * (t // 4)[:, None] + 6 * (t % 4)[:, None] + torch.arange(12)
    assert int(f.max()) < words - 2
    sample = torch.where(f < lead, 864 - lead + f, f - lead)
    idx_q, idx_i = (torch.from_numpy(a) for a in softbits.mf_index())
    assert torch.equal(sample[0::2], idx_q) and torch.equal(sample[1::2], idx_i)
    assert sample[0].tolist() == [858, 859, 860, 861, 862, 863, 0, 1, 2, 3, 4, 5]
    B = tail_b(torch.ones(12))
    for tt in range(144):  # the column of softbit t picks its own 12 words of row t // 4
        o = (f[tt] - 24 * (tt // 4)).tolist()
        assert B[:, 2 * (tt % 4)].nonzero().flatten().tolist() == [2 * x for x in o]
    packed = frame_word(words - 1) + 1
    lanes = torch.arange(32)
    g, c = lanes // 4, lanes % 4
    for mt in range(3):
        for h in (0, 8):
            j = torch.clamp(16 * mt + h + g, max=rows - 1)
            for o0 in range(0, 32, 4):
                addr = frame_word(24 * j + o0 + c)
                assert int(addr.max()) < packed
                # lanes on one word share it; distinct words meet distinct banks
                assert len(set((addr % 32).tolist())) == len(set(addr.tolist())), (mt, h, o0)


def mma_tail_model(frames: torch.Tensor, dt) -> tuple[torch.Tensor, torch.Tensor]:
    """A model of mma_tail in float32 on the CPU: the sync sums per region
    pair, then over the taps; the softbits' (X, Y) = (sum z.x pp, sum z.y
    pp) as A B, A's row j the packed frame's 32 words from 24j on as (x, y)
    pairs, B tail_b() of the taps in bf16; the derotation after the taps
    (Q rail cim X + cre Y, I rail cre X - cim Y); the mean and variance
    summed from the last softbit down. Another order of sums than
    softbits.demod's throughout."""
    pp = precision.round_bf16(dt.pp12)
    sc = precision.round_complex(dt.sync_conj)
    s = (frames[..., :42] * sc + frames[..., 336:378] * sc).flip(-1).sum(dim=-1)
    cre, cim = (s.real / s.abs())[..., None], (-s.imag / s.abs())[..., None]
    flat = torch.cat([frames[..., 858:], frames, torch.zeros_like(frames[..., :2])], dim=-1)
    a = flat[..., 24 * torch.arange(36)[:, None] + torch.arange(32)]  # (..., 36, 32)
    a = torch.stack([a.real, a.imag], dim=-1).flatten(-2)  # (..., 36, 64)
    d = a @ tail_b(pp)
    X, Y = d[..., 0::2].flatten(-2), d[..., 1::2].flatten(-2)  # softbit t = 4j + m
    q = torch.arange(144) % 2 == 0
    sb = torch.where(q, cim * X + cre * Y, cre * X - cim * Y)
    rev = sb.flip(-1)
    sav, s2av = rev.sum(dim=-1) / 144, (rev * rev).sum(dim=-1) / 144
    scale = (2.0 / (torch.sqrt(torch.clamp_min(s2av - sav * sav, 1e-30)) * 0.36))[..., None]
    sync = torch.cat([sb[..., 0:8], sb[..., 56:64]], dim=-1)
    pm = torch.cat([dt.sync_pm, dt.sync_pm])
    nbad = ((sync < 0) != (pm < 0)).sum(dim=-1).to(torch.int32)
    return scale * torch.cat([sb[..., 8:56], sb[..., 64:144]], dim=-1), nbad


def test_tensor_core_tail_model_meets_the_fast_rule(fast_rows, fast_frames):
    """The model of mma_tail against the fast plain tail softbits.demod(fast)
    on the fast main path's frames (planted wrap lags and gap patterns
    included): run_hwtests.check_survivor's fast rule, softbits within 5e-3
    relative and nbadsync unequal only where a plain sync softbit lies
    within one bf16 ulp of 0; and the model is not the plain tail's order
    of sums (the kernel cannot be bit for bit the plain version)."""
    dt = fast_rows[0].demod_tables
    sb_m, nb_m = mma_tail_model(fast_frames, dt)
    sb_p, nb_p = softbits.demod(fast_frames, dt, fast=True)
    rel = ((sb_m - sb_p).abs() / (sb_p.abs() + 1e-3)).max().item()
    assert rel < 5e-3, rel
    mism = nb_m != nb_p
    assert not mism.any() or softbits.sync_near_zero(fast_frames[mism], dt, NEAR_FAST, True)
    assert not torch.equal(sb_m, sb_p)
    assert int((nb_p < 17).sum()) == nb_p.numel()


def test_kernel_cmul_bf16_is_the_plain_cmul_bf16():
    """Kernel B2's bf16 mix, carrier and frame take a * b from b's two forms
    (common.cuh cmul_bf16): (a.x b.x, a.y b.x) plus, swapped, (a.x b.y,
    -a.y b.y), each operation rounded to bf16. Modelled on the CPU, it
    equals precision.cmul_bf16 bit for bit, signed zeros included, on bf16
    values of every scale."""
    r = precision.round_bf16
    rng = np.random.default_rng(3)
    n = 200_000
    vals = rng.normal(0, 1, (4, n)) * 2.0 ** rng.integers(-40, 40, (4, n))
    vals[:, :64] = np.array([0.0, -0.0, 1.0, -1.0])[rng.integers(0, 4, (4, 64))]
    ar, ai, br, bi = (r(torch.from_numpy(v.astype(np.float32))) for v in vals)
    want = precision.cmul_bf16(ar, ai, br, bi)
    got = (r(r(ar * br) + r(ai * -bi)), r(r(ai * br) + r(ar * bi)))
    for w, g in zip(want, got):
        assert torch.equal(w.view(torch.int32), g.view(torch.int32))


def test_kernel_compare_cuts_each_survivor_phase(tmp_path, monkeypatch):
    """tools/kernel_compare.py's phase split of kernel B2 finds the source
    line that ends each phase of this tree's kernel (staging, mix, carrier):
    every copy differs from survivor.cu by one sink, put before that line,
    that ends the block or the row; without a card the tool exits 1."""
    from msk144cudecoder_tpu_torch.tools import kernel_compare, scan_compare

    src = (kernels.CSRC_DIR / "survivor.cu").read_text()
    trees = scan_compare.split_trees(kernels.PKG_DIR, tmp_path, "this", "survivor.cu",
                                     kernel_compare.CUTS["survivor"],
                                     kernel_compare.PHASES["survivor"])
    assert list(trees) == list(kernel_compare.PHASES["survivor"])
    cuts = kernel_compare.CUTS["survivor"]["packed frame"]
    for (anchor, sink), root in zip(cuts, trees.values()):
        cut = (root / "csrc" / "survivor.cu").read_text()
        assert cut == src.replace(anchor, sink + anchor) != src
        assert sink.rstrip().endswith(("return;", "continue;"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_compare.main(["--base", str(tmp_path)]) == 1
