// Shared device helpers of the decoder's CUDA kernels (scan.cu,
// survivor.cu, bp.cu). Complex values are float2 (x = real, y = imag), the
// layout of torch.complex64.
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

}  // namespace msk
