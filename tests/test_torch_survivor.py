"""The PyTorch port's survivor demod (plain version of kernel B2) against the
JAX package's pallas_survivor.demod_survivors_ref and the Pallas kernel in
interpret mode, on the CPU, including frames that wrap the window and the
gap patterns 6 and 7.

Tolerance, the bound tests/test_survivor.py uses: nbadsync identical,
softbits |d| / (|ref| + 1e-3) < 5e-3 (float32 products and sums taken in
another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msk144cudecoder_tpu.constants as JC
from msk144cudecoder_tpu import golden as G
from msk144cudecoder_tpu.ops import pallas_survivor
from msk144cudecoder_tpu.ops import scan as jscan
from msk144cudecoder_tpu.ops import softbits as jsoftbits
from msk144cudecoder_tpu_torch.ops import softbits, survivor, tables

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
