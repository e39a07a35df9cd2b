"""The PyTorch port's tables and copied numpy modules against the JAX
package's: frequency tables bit-identical, the layouts the kernels read,
the LDPC/CRC tables, the demod constants, the configuration and the
stimulus generator."""

import dataclasses

import numpy as np
import pytest
import torch

import msk144cudecoder_tpu.constants as JC
from msk144cudecoder_tpu import golden as G
from msk144cudecoder_tpu.config import DecoderConfig as JaxConfig
from msk144cudecoder_tpu.ops import tables as jtables
from msk144cudecoder_tpu.protocol import crc as jcrc
from msk144cudecoder_tpu.protocol import ldpc_tables as jldpc
from msk144cudecoder_tpu.protocol import msg77 as jmsg77
from msk144cudecoder_tpu_torch import constants as C
from msk144cudecoder_tpu_torch import stimulus
from msk144cudecoder_tpu_torch.config import DecoderConfig
from msk144cudecoder_tpu_torch.ops import tables
from msk144cudecoder_tpu_torch.protocol import crc, ldpc_tables, msg77

torch.set_num_threads(2)

GRIDS = [JC.freq_grid(1500.0, 100.0, 2.0), JC.freq_grid(1500.0, 32.0, 1.0),
         JC.freq_grid(0.0, 200.0, 2.0)]


@pytest.mark.parametrize("grid", range(len(GRIDS)))
def test_freq_tables_bit_identical(grid):
    freqs = GRIDS[grid]
    ref = jtables.build_freq_tables(freqs)
    ours = tables.build_freq_tables(freqs)
    tt = tables.to_torch(ours, "cpu")
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name), err_msg=name)
    np.testing.assert_array_equal(tt.B.numpy(), ref.B)
    np.testing.assert_array_equal(tt.E.numpy(), ref.E)
    np.testing.assert_array_equal(tt.chi.numpy(), ref.chi[0])
    np.testing.assert_array_equal(tt.W.numpy(), ref.W)


@pytest.mark.parametrize("dec", [1, 2, 4])
def test_e_decimated_layout(dec):
    ref = jtables.build_freq_tables(GRIDS[0])
    e = tables.e_decimated(tables.to_torch(tables.build_freq_tables(GRIDS[0]), "cpu").E, dec)
    assert e.shape == (len(GRIDS[0]), C.WINDOW_LEN // dec) and e.is_contiguous()
    np.testing.assert_array_equal(e.numpy(), ref.E[::dec].T)


def test_ldpc_tables():
    lt = tables.ldpc_to_torch("cpu")
    np.testing.assert_array_equal(lt.nm.numpy(), jldpc.NM)
    np.testing.assert_array_equal(lt.crc.numpy(), jcrc.CRC_MATRIX)
    # every bit's three edges point back at it through NM
    flat = jldpc.NM.reshape(-1)
    for b in range(128):
        assert all(flat[e] == b for e in lt.mn_edge[b].tolist())
    assert sorted(lt.mn_edge.reshape(-1).tolist()) == sorted(np.nonzero(flat >= 0)[0].tolist())


def test_demod_tables():
    dt = tables.demod_to_torch("cpu")
    np.testing.assert_array_equal(dt.sync_conj.numpy(), np.conj(JC.CB42).astype(np.complex64))
    np.testing.assert_array_equal(dt.pp12.numpy(), JC.PP12.astype(np.float32))
    np.testing.assert_array_equal(dt.masks.numpy(), JC.PATTERN_MASKS)
    np.testing.assert_array_equal(dt.sync_pm.numpy(), JC.SYNC_WORD_PM)


@pytest.mark.parametrize("name", ["CB42", "PATTERN_MASKS", "PATTERN_NUM_AVG", "PP12", "FIR15",
                                  "SYNC_WORD", "SYNC_WORD_PM"])
def test_copied_constants_agree(name):
    np.testing.assert_array_equal(getattr(C, name), getattr(JC, name))


def test_copied_protocol_agrees():
    np.testing.assert_array_equal(crc.CRC_MATRIX, jcrc.CRC_MATRIX)
    np.testing.assert_array_equal(ldpc_tables.NM, jldpc.NM)
    np.testing.assert_array_equal(ldpc_tables.MN, jldpc.MN)
    np.testing.assert_array_equal(ldpc_tables.GEN_PARITY, jldpc.GEN_PARITY)
    for text in ("CQ K1ABC FN42", "K1ABC W9XYZ RR73", "W9XYZ K1ABC R-03", "TNX 73 GL"):
        bits = msg77.pack77(text)
        np.testing.assert_array_equal(bits, jmsg77.pack77(text))
        assert msg77.unpack77(bits, msg77.CallsignHashTable()) == jmsg77.unpack77(
            bits, jmsg77.CallsignHashTable())


def test_config_matches_jax_config():
    ours = {f.name: f.default for f in dataclasses.fields(DecoderConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    ref.pop("use_pallas")
    assert ours == ref
    for kw in (dict(), dict(read_mode=2), dict(search_width=500.0, search_step=1.0,
                                               scan_depth=9)):
        a, b = DecoderConfig.create(**kw), JaxConfig.create(**kw)
        np.testing.assert_array_equal(a.freqs, b.freqs)
        assert (a.scan_depth, a.num_candidates, a.center_frequency) == (
            b.scan_depth, b.num_candidates, b.center_frequency)
    with pytest.raises(ValueError):
        DecoderConfig(scan_decimation=3)


@pytest.mark.parametrize("snr,seed", [(8.0, 3), (-4.0, 1000), (None, 0)])
def test_stimulus_matches_golden(snr, seed):
    msgs = [("CQ K1ABC FN42", 1500.0), ("K1ABC W9XYZ EN37", 1460.0)]
    a = stimulus.synthesize_audio_int16(msgs, 6, snr_db=snr, rng=np.random.default_rng(seed))
    b = G.synthesize_audio_int16(msgs, 6, snr_db=snr, rng=np.random.default_rng(seed))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(stimulus.frame_bits_from_message(msgs[0][0]),
                                  G.frame_bits_from_message(msgs[0][0]))
