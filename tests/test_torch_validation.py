"""The PyTorch port's validation inputs and its sensitivity sweep on the
CPU: the IQ synthesizer and the soak scene equal the JAX package's bit for
bit, and the port's sweep decodes the same trials as the JAX CPU path (the
oracle config of ROADMAP.md: the survivor prefilter at 2K rows through the
jnp survivor demod). At width 20 the 1024-row prefilter covers the grid's
1008 candidates, so both packages resolve it to the full demod; at width 40
(1968 candidates) both run the prefilter path."""

import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msk144cudecoder_tpu import golden as G
from msk144cudecoder_tpu.config import DecoderConfig as JaxConfig
from msk144cudecoder_tpu.ops import pipeline as jpipeline
from msk144cudecoder_tpu.protocol import msg77 as jmsg77
from msk144cudecoder_tpu_torch import stimulus
from msk144cudecoder_tpu_torch.config import DecoderConfig
from msk144cudecoder_tpu_torch.ops import pipeline
from msk144cudecoder_tpu_torch.runtime.decoder import to_host
from msk144cudecoder_tpu_torch.tools import sensitivity_sweep as sweep_mod

from test_soak import _scene

SNRS = (-6.0, -8.0)
TRIALS = 4  # seeds 1000-1003


@pytest.mark.parametrize("seed", [0, 7, 1000])
def test_iq_synthesizer_matches_golden(seed):
    msgs = [("CQ K1ABC FN42", -40.0), ("K1ABC W9XYZ EN37", 35.0)]
    ours = stimulus.synthesize_iq_int8(msgs, 9, snr_db=6.0, rng=np.random.default_rng(seed))
    ref = G.synthesize_iq_int8(msgs, 9, snr_db=6.0, rng=np.random.default_rng(seed))
    assert ours.dtype == np.int8 and ours.shape == (2 * 9 * 864,)
    np.testing.assert_array_equal(ours, ref)


def test_soak_scene_matches_jax_soak():
    ours = stimulus.soak_audio(1234)
    np.testing.assert_array_equal(ours, _scene(np.random.default_rng(1234)))
    assert len(ours) == 5184 + (stimulus.SOAK_WINDOWS - 1) * 2592


def jax_sweep(width: float, snrs=SNRS, trials=tuple(range(TRIALS)),
              prefilter: int = 2 * sweep_mod.PROTOCOL["max_survivors"]) -> dict:
    """The JAX CPU path's decoded trials (seed 1000 + t for trial t) at the
    sweep's protocol but width and prefilter (0: the full demod)."""
    cfg = JaxConfig(**{**sweep_mod.PROTOCOL, "search_width": width},
                    survivor_prefilter=prefilter)
    out = {}
    for snr in snrs:
        raw = np.stack([G.synthesize_audio_int16([(sweep_mod.MESSAGE, sweep_mod.F0)], 6,
                                                 snr_db=snr, rng=np.random.default_rng(1000 + t))
                        for t in trials])
        res = jpipeline.decode_raw(jnp.asarray(raw), cfg)
        hits = []
        for b, t in enumerate(trials):
            hashes = jmsg77.CallsignHashTable()
            for k in np.nonzero(np.asarray(res.found[b]))[0]:
                ok, text = jmsg77.unpack77(
                    jpipeline.unpack_message_bits(np.asarray(res.message_bits[b][k])), hashes)
                if ok and text == sweep_mod.MESSAGE:
                    hits.append(t)
                    break
        out[snr] = hits
    return out


@pytest.mark.parametrize("width", [20.0, 40.0])
def test_sweep_matches_jax_cpu(width):
    """Trial for trial: identical at -6 dB, at most one trial apart at -8 dB
    (the noise floor, where float rounding can flip a marginal trial)."""
    cfg = DecoderConfig(**{**sweep_mod.PROTOCOL, "search_width": width})
    ours = sweep_mod.sweep(cfg, SNRS, TRIALS, "cpu")
    ref = jax_sweep(width)
    assert ours[-6.0] == ref[-6.0], (ours, ref)
    diff = sorted(set(ours[-8.0]) ^ set(ref[-8.0]))
    assert len(diff) <= 1, (diff, ours, ref)
    assert ours[-6.0], ours  # the floor is below -6 dB: the comparison is not vacuous


FLOOR_TRIALS = (2, 5, 17)  # seeds 1002, 1005, 1017


@pytest.mark.parametrize("prefilter,decoded", [(1024, [2]), (0, [2, 5, 17])])
def test_floor_trials_match_jax_cpu(prefilter, decoded):
    """At the sweep's protocol (width 500 Hz) and -8 dB, the port's CPU path
    and the JAX CPU path decode the same of trials 2, 5 and 17 with the
    1024-row prefilter and with the full demod (prefilter 0); trials 5 and
    17 decode only with the full demod, in both packages. So the port's
    5/20 at -8 dB is the JAX package's own on its prefilter path; the JAX
    package's 7/20 is its full demod's."""
    cfg = DecoderConfig(**sweep_mod.PROTOCOL, survivor_prefilter=prefilter)
    pipe = pipeline.DecodePipeline(cfg)
    raw = np.stack([sweep_mod.trial_audio(-8.0, t) for t in FLOOR_TRIALS])
    res = to_host(pipe(torch.from_numpy(raw)))
    ours = [t for b, t in enumerate(FLOOR_TRIALS) if sweep_mod.decodes_message(res, b)]
    ref = jax_sweep(sweep_mod.PROTOCOL["search_width"], (-8.0,), FLOOR_TRIALS, prefilter)[-8.0]
    assert ours == ref == decoded, (ours, ref)


def test_sweep_cli_prints_its_table():
    proc = subprocess.run(
        [sys.executable, "-m", "msk144cudecoder_tpu_torch.tools.sensitivity_sweep",
         "--device=cpu", "--trials", "2", "--search-width", "20", "--snrs", "0,-8"],
        capture_output=True, text=True, env=dict(os.environ, OMP_NUM_THREADS="2"), timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout.splitlines()
    assert out[0].startswith("message='CQ K1ABC FN42' f0=1500 width=20 step=1 depth=6 F=21 K=512")
    assert "trials=2 (seeds 1000-1001)" in out[0]
    assert re.match(r"\s+0\.0 \| cpu\s+\|\s+2/2 \|\s+100% \| 0 1$", out[2]), out
    assert re.match(r"\s+-8\.0 \| cpu\s+\|\s+[0-2]/2 \|", out[3]), out


def test_sweep_without_a_card_exits_nonzero(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sweep_mod.main(["--trials", "1", "--search-width", "4"]) == 1
