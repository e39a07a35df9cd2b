// Shared device helpers of the decoder's CUDA kernels (scan.cu,
// survivor.cu, demod.cu, bp.cu). Complex values are float2 (x = real,
// y = imag), the layout of torch.complex64.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace msk {

constexpr int kWindowLen = 5184;  // N: samples per analysis window
constexpr int kFrameLen = 864;    // samples per MSK144 frame
constexpr int kFrames = 6;        // frame slots of an averaging pattern
constexpr int kSyncTaps = 42;     // sync-correlation template length
constexpr int kSecondSync = 336;  // sample offset of the second sync word

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

// a * b
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// conj(a) * b
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.x * b.y - a.y * b.x);
}

// The fast_math policy's rounding (ops/precision.py): x rounded to bf16,
// round to nearest even, as float32.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float2 round_bf16(float2 v) {
  return __bfloat1622float2(__float22bfloat162_rn(v));
}

// A matched-filter operand: rounded to bf16 in fast mode, as it is.
template <bool kFast>
__device__ __forceinline__ float2 mf_operand(float2 v) {
  if constexpr (kFast) return round_bf16(v);
  return v;
}

// a * b with every product and sum rounded on its own (no fused
// multiply-add), as the plain versions compute it on the CPU.
__device__ __forceinline__ float2 cmul_rn(float2 a, float2 b) {
  return make_float2(__fsub_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                     __fadd_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x)));
}

// Complex bf16 values packed in 32 bits, the real part in the low half (the
// layout of __nv_bfloat162), and bf16 arithmetic on them by the sm_90 PTX
// instructions, each result rounded once to nearest even. The plain
// versions (precision.cmul_bf16) round a float32 result instead; for bf16
// operands the two agree bit for bit: a product of two bf16 values is exact
// in float32, and a float32 sum of two is exact unless their exponents lie
// 16 or more apart, where the smaller cannot move the bf16 result.
__device__ __forceinline__ unsigned pack_bf16(float2 v) {
  const __nv_bfloat162 b = __float22bfloat162_rn(v);
  return *reinterpret_cast<const unsigned*>(&b);
}

__device__ __forceinline__ float2 unpack_bf16(unsigned u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ unsigned add_bf16x2(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ unsigned mul_bf16x2(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// i * b: (-b.y, b.x)
__device__ __forceinline__ unsigned rot_bf16(unsigned b) {
  return __byte_perm(b, 0, 0x1032) ^ 0x8000u;
}

// a * b in bf16, given bi = rot_bf16(b): (a.x b.x - a.y b.y, a.x b.y + a.y b.x)
// as the two rounded products (a.x b.x, a.x b.y) plus (-a.y b.y, a.y b.x),
// rounded once more
__device__ __forceinline__ unsigned cmul_bf16(unsigned a, unsigned b, unsigned bi) {
  return add_bf16x2(mul_bf16x2(__byte_perm(a, 0, 0x1010), b),
                    mul_bf16x2(__byte_perm(a, 0, 0x3232), bi));
}

// The 12 matched-filter taps into registers, rounded to bf16 in fast mode.
template <bool kFast>
__device__ __forceinline__ void load_taps(const float* __restrict__ pp12, float (&pp)[12]) {
#pragma unroll
  for (int i = 0; i < 12; ++i) pp[i] = kFast ? round_bf16(pp12[i]) : pp12[i];
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr int kSoftbits = 144;     // channel softbits of a frame
constexpr int kSoftbitSlots = 5;   // softbits per lane in warp_tail: t = lane + 32j, j < 5

// The matched-filter tail of kernels B2 and B4 (ops/pallas_demod.py::mf_tail
// and the tail of softbits.demod), for one frame on one warp: all 32 lanes
// call it, and it passes no block barrier. fr[l] is frame sample l, l < 864:
// B2 passes its frame buffer, B4 its pattern sum ZA_p at the candidate's
// lag, ZA_p + pos (ZA_p extended by a copy of its first 864 samples, so
// that (pos + l) mod N needs no wrap).
//
// Carrier phase: s = sum_i frame[i] * conj(cb42[i]) + sum_i frame[336 + i] *
// conj(cb42[i]), i < 42, each region's taps split over the lanes (lane, lane
// + 32) and reduced by warp_sum; cfac = conj(s) / |s|. Softbits: lane holds
// t = lane + 32j (j < 5, t < 144; lanes 0-15 five, the rest four). Softbit
// t = 2q is the Q rail, the imaginary part of the derotated frame
// frame[r] * cfac over rows r = (858 + 12q + i) mod 864; t = 2q + 1 the I
// rail, the real part over rows r = 12q + i; each sums its 12 taps in order
// i = 0..11 with weights pp[i] (pp12, in the caller's registers). Row r is
// lo + i for taps i < 6 and hi + i for i >= 6: I rail lo = hi = 12q; Q rail
// lo = hi = 12q - 6, but for q = 0 lo = 858 and hi = -6 (the frame's wrap),
// so a tap is a load at a fixed offset, two taps per 16-byte load where
// they are aligned. Mean and variance of the 144: the sum of slot j over the warp,
// added in ascending j (the order of a block sum over warps of 32
// consecutive softbits), so scale = 2 / (ssig * 0.36) is the block-wide
// tail's to the bit. nbadsync: sign mismatches against the sync word at bits
// 0-7 (lanes 0-7, slot 0) and 56-63 (lanes 24-31, slot 1), by ballot and
// popcount. Out come the scaled data softbits [8:56) + [64:144), regrouped
// through `stage` (144 floats of shared memory, 16-byte aligned, the warp's
// own) as one coalesced 512-byte row, a float4 per lane, to sb_out[0..128),
// and the count to *nbad_out. kFast (ops/precision.py): every frame sample
// and sync tap is rounded to bf16 as it is read (the caller rounds pp, by
// load_taps), and every sum after that is float32, as the JAX kernels' bf16
// matched-filter dot with float32 accumulation.
template <bool kFast>
__device__ __forceinline__ void warp_tail(const float2* fr, const float2* __restrict__ sync_conj,
                                          const float (&pp)[12],
                                          const int* __restrict__ sync_pm, float* stage,
                                          float* __restrict__ sb_out, int* __restrict__ nbad_out) {
  const int lane = threadIdx.x & 31;

  float2 s1 = make_float2(0.f, 0.f);
  float2 s2 = make_float2(0.f, 0.f);
  for (int i = lane; i < kSyncTaps; i += 32) {
    const float2 sc = mf_operand<kFast>(sync_conj[i]);
    s1 = cadd(s1, cmul(mf_operand<kFast>(fr[i]), sc));
    s2 = cadd(s2, cmul(mf_operand<kFast>(fr[kSecondSync + i]), sc));
  }
  s1.x = warp_sum(s1.x);
  s1.y = warp_sum(s1.y);
  s2.x = warp_sum(s2.x);
  s2.y = warp_sum(s2.y);
  const float2 s = cadd(s1, s2);
  const float inv = 1.f / fmaxf(sqrtf(s.x * s.x + s.y * s.y), 1e-30f);
  const float cre = s.x * inv;  // cfac = conj(s) / |s|
  const float cim = -s.y * inv;

  // A lane's softbits are all on one rail (t and lane have one parity):
  // Q = z.x * cim + z.y * cre, I = z.x * cre + z.y * (-cim)
  const bool q_rail = (lane & 1) == 0;
  const float ca = q_rail ? cim : cre;
  const float cb = q_rail ? cre : -cim;
  // tap i of all of a lane's softbits at once (five independent sums), two
  // taps (16 bytes) per load where they are aligned; each softbit still adds
  // its taps in order i = 0..11
  int lo[kSoftbitSlots], hi[kSoftbitSlots];
  float v[kSoftbitSlots];
#pragma unroll
  for (int j = 0; j < kSoftbitSlots; ++j) {
    const int q = (lane + 32 * j) >> 1;
    hi[j] = q_rail ? 12 * q - 6 : 12 * q;
    lo[j] = q_rail && q == 0 ? kFrameLen - 6 : hi[j];
    v[j] = 0.f;
  }
  const int slots = lane + 32 * (kSoftbitSlots - 1) < kSoftbits ? 5 : 4;  // lanes 0-15: 5
  auto tap = [&](int j, int i, float2 z) {
    z = mf_operand<kFast>(z);
    v[j] += (z.x * ca + z.y * cb) * pp[i];
  };
  auto pair = [&](int j, int i) {  // taps i, i + 1 (same side of 6) by one 16-byte load
    const float4 w = *reinterpret_cast<const float4*>(fr + (i < 6 ? lo[j] : hi[j]) + i);
    tap(j, i, make_float2(w.x, w.y));
    tap(j, i + 1, make_float2(w.z, w.w));
  };
  auto single = [&](int j, int i) { tap(j, i, fr[(i < 6 ? lo[j] : hi[j]) + i]); };
  // lo and hi are even: fr's parity decides which taps pair up
  if ((reinterpret_cast<uintptr_t>(fr) & 8u) == 0) {
#pragma unroll
    for (int i = 0; i < 12; i += 2) {
#pragma unroll
      for (int j = 0; j < kSoftbitSlots; ++j)
        if (j < slots) pair(j, i);
    }
  } else {  // taps 0, 5, 6 and 11 alone, (1, 2), (3, 4), (7, 8), (9, 10) in pairs
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      if (i == 2 || i == 4 || i == 8 || i == 10) continue;
#pragma unroll
      for (int j = 0; j < kSoftbitSlots; ++j) {
        if (j >= slots) continue;
        if (i == 0 || i == 5 || i == 6 || i == 11)
          single(j, i);
        else
          pair(j, i);
      }
    }
  }

  float sum = 0.f, sum2 = 0.f;
#pragma unroll
  for (int j = 0; j < kSoftbitSlots; ++j) {
    sum += warp_sum(v[j]);
    sum2 += warp_sum(v[j] * v[j]);
  }
  const float sav = sum / static_cast<float>(kSoftbits);
  const float s2av = sum2 / static_cast<float>(kSoftbits);
  const float ssig = sqrtf(fmaxf(s2av - sav * sav, 1e-30f));
  const float scale = 2.f / (ssig * 0.36f);  // 2 / (ssig * sigma^2), sigma = 0.6

  const bool bad = (lane < 8 && (v[0] < 0.f ? -1 : 1) != sync_pm[lane]) ||
                   (lane >= 24 && (v[1] < 0.f ? -1 : 1) != sync_pm[lane & 7]);
  const int nbad = __popc(__ballot_sync(0xffffffffu, bad));

  // output o = 4 * lane + e is softbit o + 8 (o < 48) or o + 16: the
  // softbits pass through the warp's 144 floats of shared memory
#pragma unroll
  for (int j = 0; j < kSoftbitSlots; ++j)
    if (lane + 32 * j < kSoftbits) stage[lane + 32 * j] = v[j];
  __syncwarp();
  const float4 w = *reinterpret_cast<const float4*>(stage + 4 * lane + (lane < 12 ? 8 : 16));
  __syncwarp();  // read before the warp's next tail writes stage
  reinterpret_cast<float4*>(sb_out)[lane] =
      make_float4(scale * w.x, scale * w.y, scale * w.z, scale * w.w);
  if (lane == 0) *nbad_out = nbad;
}

// Asynchronous 8-byte copy from global to shared memory (cp.async, L1
// cached); cp_async_wait_all waits for this thread's copies.
__device__ __forceinline__ void cp_async8(void* smem_dst, const void* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The output of a row that can never survive (an index outside the tables):
// 128 zero softbits and nbadsync 17, by one warp.
__device__ __forceinline__ void warp_reject(float* __restrict__ sb_out,
                                            int* __restrict__ nbad_out) {
  const int lane = threadIdx.x & 31;
  reinterpret_cast<float4*>(sb_out)[lane] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (lane == 0) *nbad_out = 17;
}

}  // namespace msk
