"""The PyTorch port's sync scan (plain version of kernel B1) against the JAX
package's jnp scan, and once against the Pallas scan kernel in interpret
mode, on the CPU.

Tolerance: xb rtol 1e-4 / atol 1e-4; every position on the dec grid;
every position mismatch a near tie (the two xb within 1e-4 relative: the
two implementations sum the 42 taps in different orders); positions equal
in >= 99 % of the (f, p, k) slots of every pattern but the all-frames
pattern 5. That pattern sums all six frames cyclically, so its metric
repeats every 864 lags and its slice maxima tie by construction: which of
the tied slices ranks first is decided by rounding alone."""

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
