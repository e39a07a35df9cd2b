"""The PyTorch port's BP decode (plain version of kernel B3) against the JAX
package's ldpc.bp_decode and the Pallas BP kernel in interpret mode, on the
CPU: found, codeword, iterations and hard_errors identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msk144cudecoder_tpu import golden as G
from msk144cudecoder_tpu.ops import ldpc as jldpc
from msk144cudecoder_tpu.ops import pallas_ldpc
from msk144cudecoder_tpu.protocol import crc as crc_mod
from msk144cudecoder_tpu.protocol import ldpc_tables as T
from msk144cudecoder_tpu_torch.config import DecoderConfig
from msk144cudecoder_tpu_torch.ops import ldpc, pipeline, tables

torch.set_num_threads(2)
LT = tables.ldpc_to_torch("cpu")


def llr_batch(k=24, n_good=10, seed=5, amp=4.0):
    """Planted codewords plus noise, then pure-noise rows (the construction
    of tests/test_pallas.py)."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_good):
        msg = rng.integers(0, 2, 77)
        cw = T.encode(np.concatenate([msg, (crc_mod.CRC_MATRIX @ msg) % 2]))
        rows.append((2.0 * cw - 1.0) * amp + rng.normal(0, 1.0, 128))
    for _ in range(k - n_good):
        rows.append(rng.normal(0, 2.0, 128))
    return np.stack(rows).astype(np.float32)


def assert_same(ours, ref):
    for f in ("found", "codeword", "iterations", "hard_errors"):
        np.testing.assert_array_equal(getattr(ours, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)


@pytest.mark.parametrize("k,n_good,seed,amp", [(24, 10, 5, 4.0), (96, 64, 21, 2.0),
                                               (96, 80, 8, 1.8)])
def test_matches_jnp_bp(k, n_good, seed, amp):
    llr = llr_batch(k, n_good, seed, amp)
    valid = np.arange(k) % 7 != 3
    ours = ldpc.bp_decode(torch.from_numpy(llr), torch.from_numpy(valid), LT)
    ref = jldpc.bp_decode(jnp.asarray(llr), jnp.asarray(valid))
    assert_same(ours, ref)
    assert ours.found.any()
    assert ours.iterations.dtype == torch.int32 and ours.codeword.dtype == torch.int8


def test_matches_pallas_interpret():
    llr = llr_batch(24, 10, 5)
    valid = np.ones(24, bool)
    ours = ldpc.bp_decode(torch.from_numpy(llr), torch.from_numpy(valid), LT)
    ref = pallas_ldpc.bp_decode_pallas(jnp.asarray(llr), jnp.asarray(valid), interpret=True)
    assert_same(ours, ref)
    assert int(ours.found.sum()) >= 10


def test_weak_window_survivors():
    """BP on the survivor LLRs of the -4 dB stimulus: the rows the main path
    hands BP, with their real validity mask."""
    cfg = DecoderConfig(search_width=64.0, scan_depth=6, nbadsync_threshold=3,
                        max_survivors=128)
    a = G.synthesize_audio_int16([("CQ K1ABC FN42", 1500.0)], 6, snr_db=-4.0,
                                 rng=np.random.default_rng(1000))
    pipe = pipeline.DecodePipeline(cfg)
    c = pipe.preprocess(torch.from_numpy(a[None]))
    front = pipe.prefilter(*pipe.scan(c))
    prep = pipe.select(*pipe.demod(c, front), front)
    llr, valid = prep.llr[0], prep.valid[0]
    ours = ldpc.bp_decode(llr, valid, LT)
    ref = jldpc.bp_decode(jnp.asarray(llr.numpy()), jnp.asarray(valid.numpy()))
    assert_same(ours, ref)
    assert bool(ours.found.any())


def test_validity_mask_blocks_decode():
    llr = llr_batch(8, 8, 7)
    valid = np.array([True, False] * 4)
    r = ldpc.bp_decode(torch.from_numpy(llr), torch.from_numpy(valid), LT)
    assert r.found[0::2].all() and not r.found[1::2].any()
    assert (r.codeword[1::2] == 0).all() and (r.iterations[1::2] == 0).all()


def test_platanh_and_loo_match_jax():
    x = np.linspace(-1.0, 1.0, 4001, dtype=np.float32)
    np.testing.assert_array_equal(ldpc.platanh(torch.from_numpy(x)).numpy(),
                                  np.asarray(jldpc.platanh(jnp.asarray(x))))
    rng = np.random.default_rng(3)
    t = np.tanh(rng.normal(0, 2, (16, 38, 11))).astype(np.float32)
    ev = T.NM >= 0
    t = np.where(ev, t, 1.0).astype(np.float32)
    loo = ldpc.loo_log_domain(torch.from_numpy(t), torch.from_numpy(ev)).numpy()
    direct = np.stack([[[np.prod(np.delete(t[r, c], j)) for j in range(11)]
                        for c in range(38)] for r in range(16)])
    np.testing.assert_allclose(loo[:, ev], direct[:, ev], rtol=1e-4, atol=1e-6)


def test_kernel_wrapper_refuses_cpu_tensors():
    llr = torch.from_numpy(llr_batch(8, 4, 1))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ldpc.bp_decode_cuda(llr, torch.ones(8, dtype=torch.bool), LT)
