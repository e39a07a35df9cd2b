"""The PyTorch port's BP decode (plain version of kernel B3) against the JAX
package's ldpc.bp_decode and the Pallas BP kernel in interpret mode, on the
CPU: found, codeword, iterations and hard_errors identical; and kernel B3's
packed parity and CRC masks against the plain version's checks."""

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
from msk144cudecoder_tpu_torch.ops import kernels, ldpc, pipeline, precision, tables

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


def popcount(words: np.ndarray) -> np.ndarray:
    """Set bits of each int32 word (as its 32-bit pattern)."""
    return np.unpackbits(words[..., None].view(np.uint8), axis=-1).sum(axis=-1)


@pytest.mark.parametrize("kind", ["random words", "codewords", "codewords, one bit flipped"])
def test_packed_masks_match_plain_checks(kind):
    """Kernel B3's checks: each parity check and CRC row is the parity of
    popcount(mask & packed word); the verdicts equal bp_decode_plain's par
    and crc_ok on the same words."""
    rng = np.random.default_rng(11)
    if kind == "random words":
        cw = rng.integers(0, 2, (512, 128))
    else:
        msgs = rng.integers(0, 2, (512, 77))
        cw = np.stack([T.encode(np.concatenate([m, (crc_mod.CRC_MATRIX @ m) % 2])) for m in msgs])
        if kind == "codewords, one bit flipped":
            cw[np.arange(512), rng.integers(0, 128, 512)] ^= 1
    # bp_decode_plain's verdicts (ops/ldpc.py: par, crc_ok)
    cwi = torch.from_numpy(cw.astype(np.int32))
    par = (cwi[:, LT.nm.clamp_min(0).long()] * (LT.nm >= 0)).sum(dim=-1) % 2
    crc_bits = (cwi[:, None, :77] * LT.crc.to(torch.int32)).sum(dim=-1) % 2
    crc_ok = (crc_bits == cwi[:, 77:90]).all(dim=-1)
    # the kernel's: ballot words (bit b of word w is codeword bit 32w + b)
    words = tables.pack_words(cw.astype(np.uint8))
    par_k = popcount(LT.check_mask.numpy()[None] & words[:, None, :]).sum(axis=-1) & 1
    crc_par = popcount(LT.crc_mask.numpy()[None] & words[:, None, :3]).sum(axis=-1) & 1
    crc_ok_k = (crc_par == cw[:, 77:90]).all(axis=-1)
    np.testing.assert_array_equal(par_k, par.numpy())
    np.testing.assert_array_equal(crc_ok_k, crc_ok.numpy())
    if kind == "codewords":
        assert not par_k.any() and crc_ok_k.all()
    else:
        assert par_k.any() and not crc_ok_k.all()


def test_kernel_wrapper_refuses_cpu_tensors():
    llr = torch.from_numpy(llr_batch(8, 4, 1))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ldpc.bp_decode_cuda(llr, torch.ones(8, dtype=torch.bool), LT)


def test_fast_check_sums_one_word_per_edge():
    """Kernel B3's bf16 check sums, modelled on the CPU: each edge's log2
    term as its two bf16 parts in one 32-bit word (the high part in the low
    half, as pack_bf16 packs), the high parts' and the low parts' sums as
    two chains in slot order (threads 2k and 2k + 1), then split2(high +
    low), the high part read by a byte permute that moves the low half up:
    the leave-one-out equals
    ldpc.loo_log_domain(fast) bit for bit, |t| at the log2 floor included."""
    rng = np.random.default_rng(4)
    ev = T.NM >= 0
    t = np.tanh(rng.normal(0, 3, (64, 38, 11))).astype(np.float32)
    t[:, :, 0][rng.random((64, 38)) < 0.05] = 0.0
    t = np.where(ev, t, 1.0).astype(np.float32)
    lt = torch.log2(torch.clamp_min(torch.from_numpy(t).abs(), 2.0 ** -80))
    h = precision.round_bf16(lt)
    lo = precision.round_bf16(lt - h)
    word = (h.numpy().view(np.uint32) >> 16) | (lo.numpy().view(np.uint32) & 0xFFFF0000)
    high = torch.from_numpy((word << 16).view(np.float32))
    low = torch.from_numpy((word & 0xFFFF0000).view(np.float32))
    assert torch.equal(high, h) and torch.equal(low, lo)
    sh, sl = high[..., 0], low[..., 0]
    for k in range(1, 11):
        sh, sl = sh + high[..., k], sl + low[..., k]
    mag = torch.exp2(ldpc.split2(sh + sl)[..., None] - lt)
    neg = ((torch.from_numpy(t) < 0) & torch.from_numpy(ev)).to(torch.int32)
    others = neg.sum(dim=-1, keepdim=True) - neg
    loo = (1.0 - 2.0 * (others % 2).to(torch.float32)) * mag
    assert torch.equal(loo, ldpc.loo_log_domain(torch.from_numpy(t), torch.from_numpy(ev), True))


def test_kernel_compare_cuts_each_bp_phase(tmp_path):
    """tools/kernel_compare.py's phase split of kernel B3 finds the source
    line that ends each phase of an iteration of this tree's kernel (the
    per-bit sum, the tanh-log2 pass, the check sums): every copy differs
    from bp.cu by one sink, put before that line, that ends the iteration."""
    from msk144cudecoder_tpu_torch.tools import kernel_compare, scan_compare

    src = (kernels.CSRC_DIR / "bp.cu").read_text()
    trees = scan_compare.split_trees(kernels.PKG_DIR, tmp_path, "this", "bp.cu",
                                     kernel_compare.CUTS["bp"], kernel_compare.PHASES["bp"])
    assert list(trees) == list(kernel_compare.PHASES["bp"])
    for (anchor, sink), root in zip(kernel_compare.CUTS["bp"]["one word per edge"],
                                    trees.values()):
        cut = (root / "csrc" / "bp.cu").read_text()
        assert cut == src.replace(anchor, sink + anchor) != src
        assert sink.rstrip().endswith("continue;")
