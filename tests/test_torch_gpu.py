"""The PyTorch port's CUDA kernels against their plain torch versions on the
card. Marked `gpu`: each test skips without a CUDA device (the CPU suite
checks the plain versions against the JAX package instead). On a machine
with a card and nvcc, and without jax (tests/conftest.py imports it):
    python -m pytest --noconftest tests/test_torch_gpu.py -q
The tolerances are those of chip_smoke.py."""

import pathlib

import numpy as np
import pytest
import torch

from msk144cudecoder_tpu_torch import stimulus
from msk144cudecoder_tpu_torch.config import DecoderConfig
from msk144cudecoder_tpu_torch.ops import kernels, ldpc, pipeline, scan, survivor
from msk144cudecoder_tpu_torch.protocol import crc, ldpc_tables

pytestmark = pytest.mark.gpu
DEMO = pathlib.Path(__file__).resolve().parents[1] / "demo" / "capture.raw"


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.library()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def setup(cuda):
    """A default-config pipeline on the card and 4 analytic windows: three
    demo windows with pings and one of noise."""
    cfg = DecoderConfig()
    demo = np.fromfile(DEMO, dtype=np.int16)
    raw = np.stack([*stimulus.stream_windows(demo)[[2, 10, 20]],
                    np.random.default_rng(0).normal(0, 1000, 5184).astype(np.int16)])
    pipe = pipeline.DecodePipeline(cfg).to(cuda)
    return cfg, pipe, pipe.preprocess(torch.from_numpy(raw).to(cuda))


@pytest.mark.parametrize("dec", [1, 4])
def test_scan_kernel_matches_plain(setup, dec):
    cfg, _, c = setup
    pipe = pipeline.DecodePipeline(cfg.replace(scan_decimation=dec)).to(c.device)
    args = (c, pipe.B, pipe.E_dec, pipe.chi, 6, 8, dec)
    pos_k, xb_k = scan.scan_cuda(*args)
    pos_p, xb_p = scan.scan_plain(*args)
    torch.testing.assert_close(xb_k, xb_p, rtol=1e-4, atol=1e-4)
    mism = (pos_k != pos_p).cpu().numpy()
    assert mism[:, :, [0, 1, 2, 3, 4]].mean() <= 0.01  # pattern 5 ties by construction
    rel = ((xb_k - xb_p).abs() <= 1e-4 * xb_p.abs()).cpu().numpy()
    assert rel[mism].all()


def test_survivor_kernel_matches_plain(setup):
    _, pipe, c = setup
    _, pos_f, f_idx, p_idx, _ = pipe.prefilter(*pipe.scan(c))
    p_idx = p_idx.clone()
    p_idx[:, :16] = torch.arange(16, device=c.device, dtype=torch.int32) % 8  # gap patterns
    args = (c, pipe.W, pipe.chi, pos_f, f_idx, p_idx, pipe.demod_tables)
    sb_k, nb_k = survivor.demod_survivors_cuda(*args)
    sb_p, nb_p = survivor.demod_survivors_plain(*args)
    assert torch.equal(nb_k, nb_p)
    assert ((sb_k - sb_p).abs() / (sb_p.abs() + 1e-3)).max().item() < 5e-3


def test_bp_kernel_matches_plain(setup):
    _, pipe, c = setup
    rng = np.random.default_rng(1)
    rows = []
    for i in range(256):
        msg = rng.integers(0, 2, 77)
        cw = ldpc_tables.encode(np.concatenate([msg, (crc.CRC_MATRIX @ msg) % 2]))
        amp = 2.0 if i % 2 else 3.0
        rows.append((2.0 * cw - 1.0) * amp + rng.normal(0, 1.0, 128))
    llr = torch.from_numpy(np.stack(rows).astype(np.float32)).to(c.device)
    valid = torch.arange(256, device=c.device) % 5 != 0
    r_k = ldpc.bp_decode_cuda(llr, valid, pipe.ldpc_tables)
    r_p = ldpc.bp_decode_plain(llr, valid, pipe.ldpc_tables)
    for f in r_k._fields:
        assert torch.equal(getattr(r_k, f), getattr(r_p, f)), f
    assert r_k.found.any()
