"""The PyTorch port's sync scan (plain version of kernel B1) against the JAX
package's jnp scan, and once against the Pallas scan kernel in interpret
mode, on the CPU; and what surrounds kernel B1: its top-k rank rule against
the stable sort, and its frequency tiles (shared memory, coverage).

Tolerance: xb rtol 1e-4 / atol 1e-4; every position on the dec grid;
every position mismatch a near tie (the two xb within 1e-4 relative: the
two implementations sum the 42 taps in different orders); positions equal
in >= 99 % of the (f, p, k) slots of every pattern but the all-frames
pattern 5. That pattern sums all six frames cyclically, so its metric
repeats every 864 lags and its slice maxima tie by construction: which of
the tied slices ranks first is decided by rounding alone."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msk144cudecoder_tpu import golden as G
from msk144cudecoder_tpu.ops import pallas_scan
from msk144cudecoder_tpu.ops import scan as jscan
from msk144cudecoder_tpu_torch.ops import kernels, scan, tables

torch.set_num_threads(2)
FREQS = tuple(float(f) for f in np.arange(1450.0, 1551.0, 2.0))  # F = 51
ALL_FRAMES = 5  # the pattern averaging all six frames


@pytest.fixture(scope="module")
def windows():
    """(2, N) complex64: a +8 dB ping and a noise window."""
    a = G.synthesize_audio_int16([("CQ K1ABC FN42", 1500.0)], 6, snr_db=8.0,
                                 rng=np.random.default_rng(3))
    noise = np.random.default_rng(4).normal(0, 1000, 5184).astype(np.int16)
    return np.stack([G.analytic_method2(G.rms_normalize_int16(x)).astype(np.complex64)
                     for x in (a, noise)])


def port_scan(c, depth, dec, freqs=FREQS):
    tt = tables.to_torch(tables.build_freq_tables(np.asarray(freqs)), "cpu")
    return scan.scan(torch.from_numpy(c), tt.B, tables.e_decimated(tt.E, dec), tt.chi,
                     depth, dec=dec)


def assert_scan_close(pos, xb, pos_ref, xb_ref, dec):
    pos, xb = pos.numpy(), xb.numpy()
    np.testing.assert_allclose(xb, xb_ref, rtol=1e-4, atol=1e-4)
    assert (pos % dec == 0).all() and (pos >= 0).all() and (pos < 5184).all()
    mism = pos != pos_ref
    assert (np.abs(xb - xb_ref)[mism] <= 1e-4 * np.abs(xb_ref)[mism]).all()
    untied = [p for p in range(pos.shape[1]) if p != ALL_FRAMES]
    assert mism[:, untied].mean() <= 0.01, mism[:, untied].mean()


@pytest.mark.parametrize("depth", [1, 4, 6, 8])
@pytest.mark.parametrize("dec", [1, 2, 4])
def test_scan_matches_jnp(windows, depth, dec):
    pos, xb = port_scan(windows, depth, dec)
    assert pos.shape == (2, len(FREQS), depth, 8) and pos.dtype == torch.int32
    for w in range(2):
        pos_r, xb_r = jscan.scan(jnp.asarray(windows[w]), FREQS, depth, dec=dec)
        assert_scan_close(pos[w], xb[w], np.asarray(pos_r), np.asarray(xb_r), dec)


def test_scan_matches_pallas_interpret(windows):
    pos, xb = port_scan(windows[:1], 4, 4)
    pos_r, xb_r = pallas_scan.scan_pallas(jnp.asarray(windows[0]), FREQS, 4,
                                          interpret=True, dec=4)
    assert_scan_close(pos[0], xb[0], np.asarray(pos_r), np.asarray(xb_r), 4)


def test_candidate_order_and_tie_rules():
    """Slice maxima take the smallest lag on ties and the top-k slices the
    smallest slice index, as the jnp select_candidates does."""
    xb = np.zeros((1, 5184 // 4, 2), np.float32)  # (P, n2, F), dec 4
    xb[0, [3, 5, 64 + 7, 64 * 20 + 1], 0] = 2.0  # slices 0, 0, 1, 20 tie
    xb[0, 64 * 4 + 9, 1] = 5.0
    pos, top = scan.select_candidates(torch.from_numpy(xb), num_cand=4, dec=4)
    assert pos[0, 0].tolist() == [12, 256 + 28, 256 * 20 + 4, 256 * 2]
    assert top[0, 0].tolist() == [2.0, 2.0, 2.0, 0.0]
    assert pos[1, 0, 0].item() == 256 * 4 + 36


def rank_top_k(smax: torch.Tensor, k: int) -> torch.Tensor:
    """Kernel B1's top-k, written plainly: each slice's rank is the number of
    slices that beat it (larger value, or equal value and smaller index);
    the slice of rank r fills slot r."""
    n = smax.shape[-1]
    s = torch.arange(n)
    v, o = smax[..., :, None], smax[..., None, :]
    rank = ((o > v) | ((o == v) & (s[None, :] < s[:, None]))).sum(dim=-1)
    order = torch.full(smax.shape[:-1] + (k,), -1, dtype=torch.long)
    for r in range(k):
        hit = rank == r
        assert (hit.sum(dim=-1) == 1).all()  # every rank below 21 is taken once
        order[..., r] = hit.long().argmax(dim=-1)
    return order


@pytest.mark.parametrize("levels", [None, 3, 1])
def test_rank_rule_is_the_stable_sort(levels):
    """The rank rule gives select_candidates' stable descending sort order,
    with ties planted (values drawn from a few levels, or all equal)."""
    rng = np.random.default_rng(7 if levels is None else levels)
    smax = rng.random((64, 6, 21)).astype(np.float32)
    if levels is not None:
        smax = np.floor(smax * levels).astype(np.float32)
    smax = torch.from_numpy(smax)
    _, order = torch.sort(smax, dim=-1, descending=True, stable=True)
    for k in (1, 5, 8):
        assert torch.equal(rank_top_k(smax, k), order[..., :k])


@pytest.mark.parametrize("dec", [1, 2, 4])
def test_scan_tile_shared_memory_fits(dec):
    """Every tile the wrapper may choose at this dec keeps the block's shared
    memory within the 48 KB a block may use without an opt-in (the kernel
    launches without one; the card's opt-in ceiling is 232,448 bytes), at
    every depth; a tile wider than dec does not fit and is refused."""
    for n_win in (1, 2, 8, 64, 1000):
        for F in (1, 7, 101, 501):
            ft = scan.scan_tile(n_win, F, dec, 132)
            assert ft in scan.FREQ_TILES and ft <= dec
            for depth in range(1, 9):
                assert scan.scan_smem_bytes(ft, dec, depth) <= scan.SMEM_NO_OPT_IN == 49_152
    for ft in scan.FREQ_TILES:
        if ft > dec:
            with pytest.raises(ValueError):
                scan.scan_smem_bytes(ft, dec, 4)


@pytest.mark.parametrize("F", [1, 7, 101, 501])
def test_scan_tiles_cover_every_cell_once(F):
    """Kernel B1's blocks (block b: window b // tiles, frequencies from
    (b % tiles) * tile, the last tile ragged) cover every (window, f)
    exactly once; a grid that can fill the SMs does, and one window at
    F = 101 gets a block per frequency."""
    for n_win in (1, 3, 64):
        for dec in (1, 2, 4):
            ft = scan.scan_tile(n_win, F, dec, 132)
            tiles = -(-F // ft)
            cells = []
            for b in range(n_win * tiles):
                w, f0 = b // tiles, (b % tiles) * ft
                nf = min(ft, F - f0)
                assert nf >= 1
                cells += [(w, f0 + i) for i in range(nf)]
            assert sorted(cells) == [(w, f) for w in range(n_win) for f in range(F)]
            assert n_win * tiles >= min(132, n_win * F)
    assert scan.scan_tile(1, 101, 4, 132) == 1 and scan.scan_tile(64, 101, 4, 132) == 4


@pytest.mark.parametrize("dec", [1, 2, 4])
def test_scan_fast_tile_shared_memory_fits(dec):
    """The bf16 kernel runs on the float32 kernel's tiles (scan_tile): every
    tile the wrapper may choose at this dec keeps the block within the
    232,448 bytes a block may use after the opt-in (the widest needs it),
    three blocks within the SM's 233,472 (1 KB reserved each), and the slice
    maxima of every depth in the planes' place; a tile wider than dec is
    refused. The plan's
    coverage is test_scan_tiles_cover_every_cell_once's."""
    for n_win in (1, 2, 8, 64, 1000):
        for F in (1, 7, 101, 501):
            ft = scan.scan_tile(n_win, F, dec, 132)
            nbytes = scan.scan_fast_smem_bytes(ft, dec)
            assert nbytes <= scan.SMEM_OPT_IN_MAX == 232_448
            assert 3 * (nbytes + 1024) <= 233_472
            for depth in range(1, 9):
                assert 8 * ft * depth * 21 <= scan.FAST_PLANES_BYTES
    assert scan.scan_fast_smem_bytes(dec, dec) == 8 * 5184 + 31_392 > scan.SMEM_NO_OPT_IN
    for ft in scan.FREQ_TILES:
        if ft > dec:
            with pytest.raises(ValueError):
                scan.scan_fast_smem_bytes(ft, dec)


def test_fast_tile_plan_matches_the_kernel_source():
    """The wrapper's shared-memory plan uses the constants csrc/scan.cu
    compiles with: K = 48 taps, and the mma's 8 columns cover the widest
    tile."""
    src = (kernels.CSRC_DIR / "scan.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kTapsPadded") == scan.FAST_TAPS
    assert const("kMmaCols") >= max(scan.FREQ_TILES)


def test_scan_compare_cuts_each_phase(tmp_path, monkeypatch):
    """tools/scan_compare.py's phase split finds the source line that ends
    each phase of this tree's bf16 kernel: every copy differs from scan.cu
    by one sink and return, put before that line; without a card the tool
    exits 1."""
    from msk144cudecoder_tpu_torch.tools import scan_compare

    src = (kernels.CSRC_DIR / "scan.cu").read_text()
    trees = scan_compare.split_trees(kernels.PKG_DIR, tmp_path, "this")
    assert list(trees) == list(scan_compare.PHASES)
    for (anchor, sink), root in zip(scan_compare.CUTS["tensor cores"], trees.values()):
        cut = (root / "csrc" / "scan.cu").read_text()
        assert cut == src.replace(anchor, sink + anchor) != src
        assert sink.rstrip().endswith("return;")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert scan_compare.main(["--base", str(tmp_path)]) == 1


def test_public_op_dispatch_has_no_fallback(windows):
    """A CPU tensor runs the plain version; the kernel wrapper refuses a CPU
    tensor; a tensor on any other device is an error."""
    tt = tables.to_torch(tables.build_freq_tables(np.asarray(FREQS)), "cpu")
    args = (tt.B, tables.e_decimated(tt.E, 4), tt.chi, 4)
    c = torch.from_numpy(windows)
    with pytest.raises(ValueError, match="CUDA tensor"):
        scan.scan_cuda(c, *args, dec=4)
    with pytest.raises(ValueError, match="unsupported device"):
        scan.scan(c.to("meta"), *args, dec=4)
    assert kernels.on_cuda(c) is False
