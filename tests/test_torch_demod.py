"""The PyTorch port's full demod of every scan candidate (the plain version
of kernel B4) against the JAX package on the CPU: jnp
softbits.demod_candidates at depths 4, 6 and 8 with 8 and 5 candidates per
pattern, on random lags and on lags planted at the window's wrap points, and
once against the Pallas kernel pallas_demod.demod_pallas in interpret mode,
as tests/test_pallas.py runs it.

Tolerance, the bar of tests/test_pallas.py::TestPallasDemod: softbits within
rtol = atol = 2e-3 (float32 products and sums taken in another order),
nbadsync identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msk144cudecoder_tpu import golden as G
from msk144cudecoder_tpu.ops import pallas_demod
from msk144cudecoder_tpu.ops import softbits as jsoftbits
from msk144cudecoder_tpu_torch.ops import demod, kernels, softbits, tables

torch.set_num_threads(2)
FREQS = tuple(float(f) for f in np.arange(1470.0, 1502.0, 2.0))  # F = 16, the ping at 1485 Hz
WRAPS = [0, 863, 864, 4320, 4321, 5183, 5000, 2591]


@pytest.fixture(scope="module")
def windows():
    """Two analytic windows: a +6 dB ping and complex noise."""
    a = G.synthesize_audio_int16([("CQ K1ABC FN42", 1485.0)], 6, snr_db=6.0,
                                 rng=np.random.default_rng(7))
    sig = G.analytic_method2(G.rms_normalize_int16(a))
    rng = np.random.default_rng(8)
    noise = rng.normal(0, 1, 5184) + 1j * rng.normal(0, 1, 5184)
    return np.stack([sig, noise]).astype(np.complex64)


@pytest.fixture(scope="module")
def tabs():
    tt = tables.to_torch(tables.build_freq_tables(np.asarray(FREQS)), "cpu")
    return tt.W, tables.demod_to_torch("cpu")


def positions(seed: int, depth: int, k: int) -> np.ndarray:
    """(2, F, depth, k) random lags, with the wrap points planted in the
    first frequencies of both windows."""
    pos = np.random.default_rng(seed).integers(0, 5184, (2, len(FREQS), depth, k))
    flat = pos.reshape(2, -1)
    flat[:, : len(WRAPS)] = WRAPS
    flat[1, len(WRAPS) : 2 * len(WRAPS)] = WRAPS[::-1]
    return pos.astype(np.int32)


def port_demod(windows, tabs, pos):
    W, dt = tabs
    sb, nbad = demod.demod_candidates(torch.from_numpy(windows), W, torch.from_numpy(pos), dt)
    return sb.numpy(), nbad.numpy()


def assert_close(sb, nbad, sb_ref, nbad_ref):
    np.testing.assert_allclose(sb, np.asarray(sb_ref), rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(nbad, np.asarray(nbad_ref))


@pytest.mark.parametrize("depth,k", [(4, 8), (4, 5), (6, 8), (6, 5), (8, 8), (8, 5)])
def test_matches_jnp_demod_candidates(windows, tabs, depth, k):
    pos = positions(depth * 10 + k, depth, k)
    sb, nbad = port_demod(windows, tabs, pos)
    assert sb.shape == (2, len(FREQS), depth, k, 128) and nbad.shape == (2, len(FREQS), depth, k)
    for b in range(2):
        ref = jsoftbits.demod_candidates(jnp.asarray(windows[b]), FREQS, depth,
                                         jnp.asarray(pos[b]))
        assert_close(sb[b], nbad[b], *ref)


def test_matches_pallas_interpret(windows, tabs):
    pos = positions(3, 8, 8)
    sb, nbad = port_demod(windows[:1], tabs, pos[:1])
    ref = pallas_demod.demod_pallas(jnp.asarray(windows[0]), FREQS, jnp.asarray(pos[0]),
                                    interpret=True)
    assert_close(sb[0], nbad[0], *ref)


def test_stages_match_jnp(windows, tabs):
    """mix_all, pattern_average (every pattern, gap patterns 6 and 7 too)
    and gather_frames one by one."""
    W, _ = tabs
    z = softbits.mix_all(torch.from_numpy(windows), W)
    za = softbits.pattern_average(z, 8)
    pos = positions(5, 8, 8)
    frames = softbits.gather_frames(za, torch.from_numpy(pos))
    for b in range(2):
        jz = jsoftbits.mix_all(jnp.asarray(windows[b]), FREQS)
        jza = jsoftbits.pattern_average(jz, 8)
        np.testing.assert_allclose(z[b].numpy(), np.asarray(jz), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(za[b].numpy(), np.asarray(jza), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(frames[b].numpy(),
                                   np.asarray(jsoftbits.gather_frames(jza, jnp.asarray(pos[b]))),
                                   rtol=1e-5, atol=1e-5)


def test_windows_batch_equals_single(windows, tabs):
    pos = positions(6, 4, 8)
    sb, nbad = port_demod(windows, tabs, pos)
    for b in range(2):
        sb1, nb1 = port_demod(windows[b:b + 1], tabs, pos[b:b + 1])
        np.testing.assert_array_equal(nbad[b], nb1[0])
        np.testing.assert_allclose(sb[b], sb1[0], rtol=1e-6, atol=1e-6)


def test_sync_softbits_and_nbadsync_agreement(windows, tabs):
    """sync_softbits_plain gives the unscaled sync-bit softbits whose signs
    nbadsync counts; nbadsync_agreement counts unequal rows and asks each for
    a near-zero sync softbit."""
    W, dt = tabs
    pos = torch.from_numpy(positions(9, 6, 5))
    _, nbad = demod.demod_candidates(torch.from_numpy(windows), W, pos, dt)
    rows = torch.tensor([[0, 0, 0, 0], [1, 3, 5, 4], [0, 15, 2, 1]])
    sync = demod.sync_softbits_plain(torch.from_numpy(windows), W, pos, rows, dt)
    assert sync.shape == (3, 16)
    sync_word = np.concatenate([dt.sync_pm.numpy()] * 2)
    want = [int(nbad[tuple(r)]) for r in rows.tolist()]
    assert [int((np.where(s < 0, -1, 1) != sync_word).sum()) for s in sync.numpy()] == want
    c = torch.from_numpy(windows)
    assert demod.nbadsync_agreement(c, W, pos, dt, nbad, nbad.clone()) == (1.0, 0, True)
    other = nbad.clone()
    other[1, 3, 5, 4] += 1
    share, n, near = demod.nbadsync_agreement(c, W, pos, dt, nbad, other)
    assert (share, n) == (1.0 - 1 / nbad.numel(), 1)
    assert near == bool(sync[1].abs().min() < 1e-3)


def test_kernel_wrapper_refuses_cpu_tensors(windows, tabs):
    W, dt = tabs
    pos = torch.from_numpy(positions(1, 4, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        demod.demod_candidates_cuda(torch.from_numpy(windows), W, pos, dt)
    assert "demod" in kernels.launch_counts()


def test_pattern_average_is_the_ascending_frame_sum(windows, tabs):
    """Kernel B4 builds each pattern sum incrementally (the prefix patterns
    from the previous sum, 7 from 6) in the order of pattern_average; every
    pattern equals, bit for bit, its frames summed from 0 in ascending m."""
    W, dt = tabs
    z = softbits.mix_all(torch.from_numpy(windows), W)
    za = softbits.pattern_average(z, 8)
    for p, mask in enumerate(dt.masks.tolist()):
        acc = torch.zeros_like(z)
        for m in np.nonzero(mask)[0]:
            acc = acc + torch.roll(z, -864 * int(m), dims=-1)
        assert torch.equal(za[:, :, p], acc), p


def test_kernel_compare_cuts_each_demod_instantiation(tmp_path):
    """tools/kernel_compare.py's phase split of kernel B4 (z and the pattern
    sums, then the tails) finds the tail loop of each instantiation in this
    tree's demod.cu, the float32 kernel's per pattern and the bf16 kernel's
    per cell: the one copy differs from demod.cu by a sink before each, that
    ends the pattern or the cell. A demod.cu with one tail loop for both
    instantiations, as earlier trees have, is cut at that loop alone."""
    from msk144cudecoder_tpu_torch.tools import kernel_compare, scan_compare

    cuts, phases = kernel_compare.CUTS["demod"], kernel_compare.PHASES["demod"]
    src = (kernels.CSRC_DIR / "demod.cu").read_text()
    trees = scan_compare.split_trees(kernels.PKG_DIR, tmp_path / "this", "this", "demod.cu",
                                     cuts, phases)
    assert list(trees) == list(phases)
    (pairs,) = cuts["packed bf16 sums"]
    want = src
    for anchor, sink in pairs:
        assert src.count(anchor) == 1
        assert sink.rstrip().endswith(("return;", "continue;"))
        want = want.replace(anchor, sink + anchor)
    assert (trees[phases[0]] / "csrc" / "demod.cu").read_text() == want != src

    (f32_anchor, f32_sink), (fast_anchor, _) = pairs
    old = tmp_path / "old" / "msk144cudecoder_tpu_torch"
    (old / "csrc").mkdir(parents=True)
    (old / "csrc" / "demod.cu").write_text(src.replace(fast_anchor, ""))
    (root,) = scan_compare.split_trees(old, tmp_path / "old", "old", "demod.cu", cuts,
                                       phases).values()
    assert ((root / "csrc" / "demod.cu").read_text()
            == src.replace(fast_anchor, "").replace(f32_anchor, f32_sink + f32_anchor))


def test_battery_holds_demod_bf16_at_every_float32_shape():
    """The on-card battery checks kernel B4's bf16 instantiation at every
    shape it checks the float32 one: the deep scan's 64 windows, the default
    grid's 8, 2 deep windows, and depth 8 with 5 candidates per pattern."""
    from msk144cudecoder_tpu_torch.tools import run_hwtests as hw

    assert all(cfg.fast_math for cfg, _ in hw.FAST_DEMOD_CASES)
    assert [(cfg.replace(fast_math=False), nw) for cfg, nw in hw.FAST_DEMOD_CASES] == list(
        hw.DEMOD_CASES)
