// Kernel B1: the wideband sync scan.
//
// Replaces msk144cudecoder_tpu/ops/pallas_scan.py::_scan_kernel (launched by
// scan_pallas). Same result as the plain torch version in ops/scan.py
// (scan_plain), with the JAX jnp scan's exact-f32 tie order, not the Pallas
// kernel's packed keys.
//
// Per (window, frequency f), on the coarse lag grid l' in [0, N/dec):
//   G[l'] = E[f, l'] * sum_{i<42} conj(c[(dec*l' + i) mod N]) * B[i, f],
//           the taps with dec*l' + i >= N also times (1 + chi_f) (written as
//           R + chi * D, D the sum of the wrapped taps, as the plain version)
//   s_p[l'] = sum_{m in mask_p} G[l' + 864m/dec] + G[l' + (864m + 336)/dec]
//           (mod N/dec; every roll is divisible by dec), in the plain
//           version's order: prefix sums for patterns 0-5, gap patterns
//           6 = {0,3} and 7 = {0,3,4}
//   per slice of 256 lags (21 slices, the head wraps): the max of |s_p|,
//   smallest lag winning ties; then the top-k slices, smallest slice index
//   winning ties; pos = (256 * slice + dec * lag_in_slice) mod N.
//
// What bounds it on the H100: not FLOPs (about 44 MFLOP for a window at
// F = 101, dec = 4) and not device memory (the window is 41 KB and the E row
// 10 KB per block), but latency and occupancy: one block per (window, f)
// gives only B*F blocks, fewer than the 132 SMs at B = 1. The design keeps
// the whole field G of one frequency in shared memory (41 KB at dec = 1),
// so the pattern sums and slice maxima never touch device memory: the
// Pallas kernel's (P, N, F) metric field is never formed. Each warp takes
// whole slices and reduces (max, argmax) with shuffles; one thread picks
// the top-k of the 21 slice maxima. The 42-tap correlation is a plain FP32
// loop, not a tensor-core product: the field is too small to pay for one.

#include "common.cuh"

namespace {

using namespace msk;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlice = 256;
constexpr int kSlices = 21;

__device__ __forceinline__ float2 term(const float2* G, int l, int m, int n2, int dec) {
  // T_m(l) = G[l + 864m/dec] + G[l + (864m + 336)/dec], indices mod n2
  // (both offsets are below n2, so one wrap at most)
  int a = l + (kFrameLen * m) / dec;
  int b = l + (kFrameLen * m + kSecondSync) / dec;
  a -= (a >= n2) ? n2 : 0;
  b -= (b >= n2) ? n2 : 0;
  return cadd(G[a], G[b]);
}

__device__ __forceinline__ float pattern_metric(const float2* G, int l, int p, int n2,
                                                int dec) {
  float2 s;
  if (p < 6) {
    s = term(G, l, 0, n2, dec);
    for (int m = 1; m <= p; ++m) s = cadd(s, term(G, l, m, n2, dec));
  } else {
    s = cadd(term(G, l, 0, n2, dec), term(G, l, 3, n2, dec));
    if (p == 7) s = cadd(s, term(G, l, 4, n2, dec));
  }
  return hypotf(s.x, s.y);
}

__global__ void __launch_bounds__(kThreads)
scan_kernel(const float2* __restrict__ c, const float2* __restrict__ B,
            const float2* __restrict__ E_dec, const float2* __restrict__ chi,
            int* __restrict__ pos_out, float* __restrict__ xb_out, int F, int depth,
            int num_cand, int dec) {
  __shared__ float2 G[kWindowLen];  // n2 = N/dec entries used
  __shared__ float2 Bs[kSyncTaps];
  __shared__ float smax[kSlices];
  __shared__ int sarg[kSlices];

  const int f = blockIdx.x % F;
  const int w = blockIdx.x / F;
  const int n2 = kWindowLen / dec;
  const float2* cw = c + static_cast<size_t>(w) * kWindowLen;
  if (threadIdx.x < kSyncTaps) Bs[threadIdx.x] = B[threadIdx.x * F + f];
  __syncthreads();

  const float2 x = chi[f];
  const float2* Ef = E_dec + static_cast<size_t>(f) * n2;
  for (int l = threadIdx.x; l < n2; l += kThreads) {
    const int lag = l * dec;
    float2 R = make_float2(0.f, 0.f);
    float2 D = make_float2(0.f, 0.f);
    for (int i = 0; i < kSyncTaps; ++i) {
      int t = lag + i;
      const bool wrapped = t >= kWindowLen;
      t -= wrapped ? kWindowLen : 0;
      const float2 v = cmul_conj(cw[t], Bs[i]);
      R = cadd(R, v);
      if (wrapped) D = cadd(D, v);
    }
    G[l] = cmul(Ef[l], cadd(R, cmul(x, D)));
  }
  __syncthreads();

  const int slice2 = kSlice / dec;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int p = 0; p < depth; ++p) {
    for (int s = warp; s < kSlices; s += kWarps) {
      float best = -1.f;
      int arg = slice2;
      for (int j = lane; j < slice2; j += 32) {
        int l = s * slice2 + j;
        l -= (l >= n2) ? n2 : 0;
        const float v = pattern_metric(G, l, p, n2, dec);
        if (v > best) {  // lanes walk j upward: the first maximum stays
          best = v;
          arg = j;
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, o);
        const int oa = __shfl_xor_sync(0xffffffffu, arg, o);
        if (ob > best || (ob == best && oa < arg)) {
          best = ob;
          arg = oa;
        }
      }
      if (lane == 0) {
        smax[s] = best;
        sarg[s] = arg;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned taken = 0u;
      const size_t out = (static_cast<size_t>(w * F + f) * depth + p) * num_cand;
      for (int k = 0; k < num_cand; ++k) {
        int bs = -1;
        float bv = -2.f;
        for (int s = 0; s < kSlices; ++s) {
          if (!(taken & (1u << s)) && smax[s] > bv) {  // lowest slice wins ties
            bv = smax[s];
            bs = s;
          }
        }
        taken |= 1u << bs;
        pos_out[out + k] = (kSlice * bs + dec * sarg[bs]) % kWindowLen;
        xb_out[out + k] = bv;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Plain C interface (ctypes). Launches on `stream`; returns cudaGetLastError().
extern "C" int msk_scan(const void* c, const void* B, const void* E_dec, const void* chi,
                        void* pos_out, void* xb_out, int n_win, int F, int depth,
                        int num_cand, int dec, void* stream) {
  if (n_win <= 0 || F <= 0) return 0;
  if (depth < 1 || depth > 8 || num_cand < 1 || num_cand > 8 ||
      (dec != 1 && dec != 2 && dec != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  scan_kernel<<<n_win * F, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(c), static_cast<const float2*>(B),
      static_cast<const float2*>(E_dec), static_cast<const float2*>(chi),
      static_cast<int*>(pos_out), static_cast<float*>(xb_out), F, depth, num_cand, dec);
  return static_cast<int>(cudaGetLastError());
}

// The message of a CUDA error code, for the Python wrappers' exceptions.
extern "C" const char* msk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
