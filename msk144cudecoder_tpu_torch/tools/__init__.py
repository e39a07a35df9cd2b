"""Validation tools of the PyTorch port, run as modules:
`python -m msk144cudecoder_tpu_torch.tools.sensitivity_sweep` and
`python -m msk144cudecoder_tpu_torch.tools.run_hwtests`."""
