"""The fast_math precision policy: bf16 inputs, float32 accumulation.

DecoderConfig(fast_math=True) selects, on the card and on the CPU alike,
the precision ladder the JAX package's TPU kernels run by default
(msk144cudecoder_tpu/config.py:78-94). Each kernel's plain version calls
round_bf16 at exactly the points below and computes everything else in
float32; kernels B1-B4 round at the same points (csrc/, `kFast`). A bf16
product of two bf16 values is exact in float32, so a "bf16 input, f32
accumulate" dot is the float32 sum of exact products. "In bf16" below means
that every single operation is rounded to bf16 (round to nearest even), as
bf16 arithmetic on the TPU's vector unit. Every path through the JAX
package that is not fast keeps float32.

B1, the sync scan (msk144cudecoder_tpu/ops/pallas_scan.py):
  - the lag planes cr, ci and cd = cr - ci (cd taken in float32 from the
    window, then rounded) are bf16 (:291-294, :413);
  - the B operands br, bi and bs = br + bi likewise (:324-327);
  - conj(c) . B is the Karatsuba form of three products, m1 = cr.br,
    m2 = ci.bi, m3 = cd.bs, each summed over the 42 taps in float32;
    re = m1 + m2, im = m3 - m1 + m2 (:121-136);
  - the wrap correction D over the wrapped taps is the same form on the
    same rounded operands (:87-90, :156);
  - chi * D, the phase ramp E, the pattern combine and |s| stay float32.
B2, the survivor demod (ops/pallas_survivor.py):
  - the window planes are bf16 (:107-109);
  - the per-frequency table fetch is one bf16 pass (:191-197): W[f, 128q],
    W[f, r], W[f, 864m] and conj(1 + chi) round to bf16 per component;
    W[f, pos] = W[f, 128q] W[f, r] and the gamma products stay float32
    (:203-219);
  - the gamma picks are cast to bf16 (:285-286);
  - the mix c * gamma, its difference and sum, and the pattern sum over
    the frames are in bf16 (:290-296);
  - the carrier W[f, 128j + r] = W[f, 128j] W[f, r] from those bf16 table
    values, and the frame times the carrier, are in bf16 (:334-346);
  - the matched filter and the sync-phase sum take bf16 operands, the
    frame and M (the pp12 taps, conj(cb42)), with float32 accumulation
    (:350-351); the tail after it (pallas_demod.py:284 mf_tail) is float32.
B3, LDPC belief propagation (ops/pallas_ldpc.py):
  - check-to-bit messages are cast to bf16 before the per-bit sum, which is
    float32; zn = llr + that sum (:153-155);
  - zn is cast to bf16 for the bit-to-check copy; toc = bf16(zn) - tov
    keeps the unrounded tov (:186-190);
  - log2|t| splits into two bf16 parts h + l (about 16 mantissa bits),
    the row sum S = sum(h) + sum(l) is float32, and S splits into two bf16
    parts again for the broadcast back to the edges (:199-207);
  - tanh, exp2, platanh, parity and the CRC are unchanged.
B4, the full demod (ops/pallas_demod.py):
  - the matched filter is a dot at Precision.DEFAULT on float32 operands
    (:159-160, :275-276, selected at :412), one bf16 pass on the TPU: the
    frame samples (float32 mix and pattern sums) and M round to bf16, with
    float32 accumulation.

The port's matched-filter tail (softbits.demod, msk::warp_tail) derotates
each frame sample before its taps, where mf_tail derotates the filter's
outputs: the same linear map, so in fast mode it rounds the frame samples
and the taps (pp12, conj(cb42)) to bf16 once and takes every sum and the
derotation after that in float32.
"""

from __future__ import annotations

import torch


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (round to nearest even), as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def round_complex(z: torch.Tensor) -> torch.Tensor:
    """Each part of complex64 z rounded to bf16."""
    return torch.complex(round_bf16(z.real), round_bf16(z.imag))


def cmul_bf16(ar: torch.Tensor, ai: torch.Tensor, br: torch.Tensor,
              bi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(ar + i ai) * (br + i bi) in bf16: each of the four products, then
    the difference and the sum, rounded to bf16."""
    r = round_bf16
    return r(r(ar * br) - r(ai * bi)), r(r(ar * bi) + r(ai * br))
