"""The PyTorch port's pipeline glue and the whole slice against the JAX
package on the CPU.

Glue (prefilter_select, the survivor selections, split_quota,
resolve_prefilter, finish_window, pack_message_bits): identical numpy inputs,
built with ties, give identical indices and arrays. End to end: the port's
decode_raw against the JAX decode_raw on its kernel branch (Pallas kernels in
interpret mode, as tests/test_pallas.py runs it) on a +8 dB ping, the -4 dB
stimulus, noise, and two pings overlapping in time: the decode sets, per
message (num_avg, nbadsync, f0), and the count of found rows are identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msk144cudecoder_tpu.constants as JC
from msk144cudecoder_tpu import golden as G
from msk144cudecoder_tpu.config import DecoderConfig as JaxConfig
from msk144cudecoder_tpu.ops import ldpc as jldpc
from msk144cudecoder_tpu.ops import pipeline as jpipeline
from msk144cudecoder_tpu.protocol import msg77
from msk144cudecoder_tpu_torch.config import DecoderConfig
from msk144cudecoder_tpu_torch.ops import ldpc, pipeline

torch.set_num_threads(2)
E2E = dict(search_width=64.0, scan_depth=6, nbadsync_threshold=3, max_survivors=128)


def tied_xb(rng, shape, levels=6):
    """Non-negative xb on a coarse grid (so values tie), each cell's slots in
    descending order as the scan emits them."""
    return -np.sort(-rng.integers(0, levels, shape).astype(np.float32) / 4.0, axis=-1)


@pytest.mark.parametrize("F,P,pre,per_cell", [(17, 4, 128, 2), (9, 6, 64, 3), (30, 1, 50, 2)])
def test_prefilter_select_identical(F, P, pre, per_cell):
    rng = np.random.default_rng(F * P)
    xb = tied_xb(rng, (2, F, P, 8))
    pos = rng.integers(0, 5184, (2, F, P, 8)).astype(np.int32)
    ours = pipeline.prefilter_select(torch.from_numpy(xb), torch.from_numpy(pos), pre, per_cell)
    for b in range(2):
        ref = jpipeline.prefilter_select(jnp.asarray(xb[b]), jnp.asarray(pos[b]), pre,
                                         per_cell, None)
        for a, r in zip(ours, ref):
            np.testing.assert_array_equal(a[b].numpy(), np.asarray(r))


@pytest.mark.parametrize("k", [1, 37, 200])
def test_select_survivors_identical(k):
    rng = np.random.default_rng(k)
    nbad = rng.integers(0, 4, (3, 200)).astype(np.int32)
    xb = rng.integers(0, 5, (3, 200)).astype(np.float32)
    ours = pipeline.select_survivors(torch.from_numpy(nbad), torch.from_numpy(xb), k)
    for b in range(3):
        ref = jpipeline.select_survivors(jnp.asarray(nbad[b]), jnp.asarray(xb[b]), k)
        np.testing.assert_array_equal(ours[b].numpy(), np.asarray(ref))


@pytest.mark.parametrize("thr", [1, 3])
def test_select_survivors_topk_identical(thr):
    rng = np.random.default_rng(thr)
    nbad = rng.integers(0, 8, (2, 300)).astype(np.int32)
    xb = (rng.integers(0, 6, (2, 300)) * 0.5).astype(np.float32)
    ours = pipeline.select_survivors_topk(torch.from_numpy(nbad), torch.from_numpy(xb), 64, thr)
    for b in range(2):
        ref = jpipeline.select_survivors_topk(jnp.asarray(nbad[b]), jnp.asarray(xb[b]), 64, thr)
        np.testing.assert_array_equal(ours[b].numpy(), np.asarray(ref))


@pytest.mark.parametrize("nc,k,P", [(512, 256, 4), (384, 128, 6), (100, 33, 5)])
def test_select_survivors_quota_and_split_quota(nc, k, P):
    rng = np.random.default_rng(nc + P)
    nbad = rng.integers(0, 5, (2, nc)).astype(np.int32)
    xb = rng.integers(0, 7, (2, nc)).astype(np.float32)
    assert pipeline.split_quota(nc, P) == jpipeline.split_quota(nc, P)
    offs = np.cumsum([0] + pipeline.split_quota(nc, P))
    quotas = list(zip(pipeline.split_quota(k, P),
                      [slice(int(offs[p]), int(offs[p + 1])) for p in range(P)]))
    ours = pipeline.select_survivors_quota(torch.from_numpy(nbad), torch.from_numpy(xb), k,
                                           quotas)
    for b in range(2):
        ref = jpipeline.select_survivors_quota(jnp.asarray(nbad[b]), jnp.asarray(xb[b]), k, 1,
                                               quotas)
        np.testing.assert_array_equal(ours[b].numpy(), np.asarray(ref))


def test_resolve_prefilter_matches_kernel_branch():
    for kw in (dict(), dict(survivor_prefilter=100), dict(survivor_prefilter=0),
               dict(survivor_prefilter=30000), dict(max_survivors=64)):
        for nc in (1632, 24048, 500):
            assert pipeline.resolve_prefilter(DecoderConfig(**kw), nc) == \
                jpipeline.resolve_prefilter(JaxConfig(**kw), nc, True)


def test_finish_window_identical():
    rng = np.random.default_rng(4)
    k = 96
    prep = jpipeline.PreparedWindow(
        llr=jnp.zeros((k, 128), jnp.float32),
        valid=jnp.asarray(rng.random(k) < 0.7),
        nbad_k=jnp.asarray(rng.integers(0, 4, k).astype(np.int32)),
        xb_k=jnp.asarray(rng.random(k).astype(np.float32)),
        pos_k=jnp.asarray(rng.integers(0, 5184, k).astype(np.int32)),
        cand_k=jnp.asarray(rng.integers(0, 9000, k).astype(np.int32)),
        num_survivors=jnp.asarray(77, jnp.int32),
        block_power=jnp.asarray(rng.random(8).astype(np.float32)))
    bp = jldpc.BPResult(found=jnp.asarray(rng.random(k) < 0.2),
                        codeword=jnp.asarray(rng.integers(0, 2, (k, 128)).astype(np.int8)),
                        iterations=jnp.asarray(rng.integers(0, 10, k).astype(np.int32)),
                        hard_errors=jnp.asarray(rng.integers(0, 18, k).astype(np.int32)))
    cfg = DecoderConfig(max_results=40)
    ref = jpipeline.finish_window(prep, bp, JaxConfig(max_results=40))

    def t(a):
        return torch.from_numpy(np.array(a))[None]

    ours = pipeline.finish_stage(
        pipeline.PreparedWindows(llr=t(prep.llr), valid=t(prep.valid), nbad_k=t(prep.nbad_k),
                                 xb_k=t(prep.xb_k), pos_k=t(prep.pos_k), cand_k=t(prep.cand_k),
                                 num_survivors=t(prep.num_survivors)),
        ldpc.BPResult(*(t(a) for a in bp)), t(prep.block_power), cfg)
    for f in ref._fields:
        np.testing.assert_array_equal(getattr(ours, f)[0].numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    sel = np.argsort(~np.asarray(bp.found), kind="stable")[:40]  # decodes first
    np.testing.assert_array_equal(pipeline.unpack_message_bits(ours.message_bits[0].numpy()),
                                  np.asarray(bp.codeword)[sel, :77])


def test_unimplemented_paths_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pipeline.DecodePipeline(DecoderConfig(survivor_prefilter=0))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pipeline.DecodePipeline(DecoderConfig(), chan_valid=np.ones(101, bool))


def stimuli() -> np.ndarray:
    a = G.synthesize_audio_int16([("CQ K1ABC FN42", 1500.0)], 6, snr_db=8.0,
                                 rng=np.random.default_rng(3))
    weak = G.synthesize_audio_int16([("CQ K1ABC FN42", 1500.0)], 6, snr_db=-4.0,
                                    rng=np.random.default_rng(1000))
    noise = np.random.default_rng(11).normal(0, 1000, 5184).astype(np.int16)
    two = G.synthesize_audio_int16([("K1ABC W9XYZ EN37", 1478.0), ("W9XYZ K1ABC RR73", 1516.0)],
                                   6, snr_db=4.0, rng=np.random.default_rng(9))
    return np.stack([a, weak, noise, two])


def summary(res, unpack_cfg, b):
    """message -> (lowest (num_avg, nbadsync), f0 of that row) of window b,
    and the count of found rows."""
    found = np.asarray(res.found[b])
    best = {}
    hashes = msg77.CallsignHashTable()
    for k in np.nonzero(found)[0]:
        ok, text = msg77.unpack77(pipeline.unpack_message_bits(
            np.asarray(res.message_bits[b][k])), hashes)
        if not ok:
            continue
        fi, pi, _ = pipeline.unpack_candidate_index(unpack_cfg, int(res.cand_index[b][k]))
        key = (int(JC.PATTERN_NUM_AVG[pi]), int(res.nbadsync[b][k]), float(unpack_cfg.freqs[fi]))
        best[text] = min(best.get(text, key), key)
    return best, int(found.sum())


def test_decode_raw_matches_jax_kernel_branch():
    raw = stimuli()
    cfg = DecoderConfig(**E2E)
    ours = pipeline.decode_raw(raw, cfg)
    ref = jpipeline.decode_raw(jnp.asarray(raw), JaxConfig(use_pallas=True, **E2E))
    expect = [{"CQ K1ABC FN42"}, {"CQ K1ABC FN42"}, set(),
              {"K1ABC W9XYZ EN37", "W9XYZ K1ABC RR73"}]
    for b in range(len(raw)):
        s_ours, s_ref = summary(ours, cfg, b), summary(ref, cfg, b)
        assert s_ours == s_ref, (b, s_ours, s_ref)
        assert set(s_ours[0]) == expect[b], (b, s_ours)
    assert ours.num_survivors.shape == (4,) and ours.block_power.shape == (4, 8)
