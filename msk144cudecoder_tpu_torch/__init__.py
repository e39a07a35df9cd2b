"""msk144cudecoder_tpu_torch — the MSK144 stream decoder in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package msk144cudecoder_tpu, which stays the reference:
the same configuration, decode paths and output lines, with the four
kernels (sync scan, survivor demod, full demod of every candidate, LDPC
belief propagation) written in CUDA C++ under csrc/. On a CPU tensor every
kernel's plain torch version runs instead. This package never imports jax.
"""

__version__ = "0.1.0"
