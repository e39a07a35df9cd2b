"""The PyTorch port's preprocessing against the JAX package's
(ops/analytic.py, pipeline.preprocess and block_powers) on the CPU, within
abs 1e-5 on complex64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msk144cudecoder_tpu import golden as G
from msk144cudecoder_tpu.config import DecoderConfig as JaxConfig
from msk144cudecoder_tpu.ops import analytic as janalytic
from msk144cudecoder_tpu.ops import pipeline as jpipeline
from msk144cudecoder_tpu_torch.config import DecoderConfig
from msk144cudecoder_tpu_torch.ops import analytic, pipeline

torch.set_num_threads(2)
ATOL = 1e-5


@pytest.fixture(scope="module")
def audio():
    a = G.synthesize_audio_int16([("CQ K1ABC FN42", 1500.0)], 6, snr_db=8.0,
                                 rng=np.random.default_rng(3))
    noise = np.random.default_rng(4).normal(0, 1000, 5184).astype(np.int16)
    return np.stack([a, noise])


def test_rms_normalize(audio):
    ours = analytic.rms_normalize(torch.from_numpy(audio)).numpy()
    ref = np.asarray(janalytic.rms_normalize(jnp.asarray(audio)))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("method", [1, 2])
def test_analytic_methods(audio, method):
    x = np.array(janalytic.rms_normalize(jnp.asarray(audio)))
    ref = np.asarray((janalytic.analytic_method1 if method == 1
                      else janalytic.analytic_method2)(jnp.asarray(x)))
    ours = (analytic.analytic_method1 if method == 1
            else analytic.analytic_method2)(torch.from_numpy(x))
    assert ours.dtype == torch.complex64 and ours.is_contiguous()
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=ATOL)


def test_iq_filter():
    iq = G.synthesize_iq_int8([("K1ABC W9XYZ EN37", 20.0)], 6, snr_db=10.0,
                              rng=np.random.default_rng(6)).astype(np.float32) / 128.0
    z = iq[0::2] + 1j * iq[1::2]
    ref = np.asarray(janalytic.iq_filter(jnp.asarray(z.astype(np.complex64))))
    ours = analytic.iq_filter(torch.from_numpy(z.astype(np.complex64))).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("kw", [dict(), dict(analytic_method=1), dict(read_mode=2)],
                         ids=["audio-m2", "audio-m1", "iq"])
def test_preprocess_and_block_powers(kw):
    rng = np.random.default_rng(8)
    if kw.get("read_mode") == 2:
        raw = rng.integers(-100, 100, (2, 10368)).astype(np.int8)
    else:
        raw = rng.normal(0, 1000, (2, 5184)).astype(np.int16)
    cfg = DecoderConfig.create(search_width=32.0, **kw)
    jcfg = JaxConfig.create(search_width=32.0, **kw)
    c = pipeline.DecodePipeline(cfg).preprocess(torch.from_numpy(raw))
    ref = np.asarray(jpipeline.preprocess(jnp.asarray(raw), jcfg))
    np.testing.assert_allclose(c.numpy(), ref, rtol=0, atol=ATOL)
    bp = pipeline.block_powers(c).numpy()
    bp_ref = np.stack([np.asarray(jpipeline.block_powers(jnp.asarray(r))) for r in ref])
    np.testing.assert_allclose(bp, bp_ref, rtol=1e-5)
