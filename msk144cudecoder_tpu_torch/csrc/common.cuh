// Shared device helpers of the decoder's CUDA kernels (scan.cu,
// survivor.cu, demod.cu, bp.cu). Complex values are float2 (x = real,
// y = imag), the layout of torch.complex64.
#pragma once

#include <cstdint>

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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the whole block (every thread must call it); `scratch`
// holds one float per warp. The result is the same on every thread.
template <int kThreads>
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  constexpr int kWarps = kThreads / 32;
  v = warp_sum(v);
  __syncthreads();  // scratch may still be read by a previous call
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < kWarps; ++i) t += scratch[i];
  return t;
}

constexpr int kSoftbits = 144;  // channel softbits of a frame

// Shared memory of mf_tail: `kThreads` is the block size.
template <int kThreads>
struct TailSmem {
  float sb[kSoftbits];
  float2 sync_part[2];
  float scratch[kThreads / 32];
};

// The matched-filter tail of kernels B2 and B4 (ops/pallas_demod.py::mf_tail
// and the tail of softbits.demod). Frame sample l (l < 864) is
// buf[(start + l) mod len], start in [0, len), so B2 passes its frame
// (start 0, len 864) and B4 its pattern sum ZA_p at the candidate's lag
// (len N). Steps: s = sum frame * conj(cb42) over samples [0, 42) and
// [336, 378); cfac = conj(s)/|s|; the 144 matched-filter softbits of the
// derotated frame: Q at column 2q from the imaginary part over rows
// (858 + 12q + i) mod 864, I at column 2q+1 from the real part over rows
// 12q + i; mean and variance over the 144 give scale = 2/(ssig * 0.36);
// nbadsync counts the sign mismatches against the sync word at bits 0-7 and
// 56-63; out come the scaled data softbits [8:56) + [64:144) to
// sb_out[0..128) and the count to *nbad_out. Every thread of the block
// calls it with the same arguments (it synchronises the block); it reads
// buf only before its last barrier, so the caller may overwrite buf once it
// returns.
template <int kThreads>
__device__ __forceinline__ void mf_tail(const float2* buf, int start, int len,
                                        const float2* __restrict__ sync_conj,
                                        const float* __restrict__ pp12,
                                        const int* __restrict__ sync_pm,
                                        TailSmem<kThreads>& sm, float* __restrict__ sb_out,
                                        int* __restrict__ nbad_out) {
  static_assert(kThreads >= kSoftbits && kThreads % 32 == 0, "one thread per softbit");
  auto at = [&](int l) {
    const int i = start + l;
    return buf[i >= len ? i - len : i];
  };

  // carrier phase: warp 0 sums the first sync region, warp 1 the second
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp < 2) {
    const int base = warp == 0 ? 0 : kSecondSync;
    float2 v = make_float2(0.f, 0.f);
    for (int i = lane; i < kSyncTaps; i += 32) v = cadd(v, cmul(at(base + i), sync_conj[i]));
    v.x = warp_sum(v.x);
    v.y = warp_sum(v.y);
    if (lane == 0) sm.sync_part[warp] = v;
  }
  __syncthreads();
  const float2 s = cadd(sm.sync_part[0], sm.sync_part[1]);
  const float inv = 1.f / fmaxf(sqrtf(s.x * s.x + s.y * s.y), 1e-30f);
  const float cre = s.x * inv;  // cfac = conj(s) / |s|
  const float cim = -s.y * inv;

  float v = 0.f;
  if (threadIdx.x < kSoftbits) {
    const int q = threadIdx.x >> 1;
    for (int i = 0; i < 12; ++i) {
      if ((threadIdx.x & 1) == 0) {  // Q rail: imag of the derotated frame
        const float2 z = at((858 + 12 * q + i) % kFrameLen);
        v += (z.x * cim + z.y * cre) * pp12[i];
      } else {  // I rail: real part
        const float2 z = at(12 * q + i);
        v += (z.x * cre - z.y * cim) * pp12[i];
      }
    }
    sm.sb[threadIdx.x] = v;
  }
  const float sav = block_sum<kThreads>(v, sm.scratch) / static_cast<float>(kSoftbits);
  const float s2av = block_sum<kThreads>(v * v, sm.scratch) / static_cast<float>(kSoftbits);
  const float ssig = sqrtf(fmaxf(s2av - sav * sav, 1e-30f));
  const float scale = 2.f / (ssig * 0.36f);  // 2 / (ssig * sigma^2), sigma = 0.6

  // each thread reads back only its own softbit sb[t]
  const int t = threadIdx.x;
  bool bad = false;
  if (t < 8 || (t >= 56 && t < 64)) {
    const int hard = sm.sb[t] < 0.f ? -1 : 1;
    bad = hard != sync_pm[t & 7];
  }
  const int nbad = __syncthreads_count(bad);
  if (t >= 8 && t < 56) sb_out[t - 8] = scale * sm.sb[t];
  if (t >= 64 && t < kSoftbits) sb_out[t - 16] = scale * sm.sb[t];
  if (t == 0) *nbad_out = nbad;
}

}  // namespace msk
