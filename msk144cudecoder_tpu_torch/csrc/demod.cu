// Kernel B4: the full demod of every scan candidate (survivor_prefilter=0).
//
// Replaces msk144cudecoder_tpu/ops/pallas_demod.py::_demod_kernel (launched
// by demod_pallas) and its tail mf_tail. Same result as the plain torch
// version softbits.demod_candidates (ops/demod.py, demod_candidates_plain).
//
// One block per (window b, frequency f), all B*F blocks in one launch:
//   z[t]    = c[t] * W[f, t]                                   t < N
//   ZA_p[t] = sum_{m ascending, mask_p[m]} z[(t + 864m) mod N]  per pattern p
// z and ZA_p live in shared memory (2 x 41.5 KB, dynamic). For each pattern
// the block builds ZA_p once and runs its k candidates one after another
// through the matched-filter tail msk::mf_tail (common.cuh, shared with
// kernel B2), which reads candidate j's frame as ZA_p[(pos + l) mod N],
// l < 864. The sums run in the order of softbits.pattern_average (the
// prefix sums of patterns 0-5 add the frames in ascending m, as do the gap
// patterns 6 = {0, 3} and 7 = {0, 3, 4}), so ZA_p matches the plain version
// up to the rounding of the products.
//
// What bounds it on the H100: the window and W[f] are read once per block
// (83 KB, from L2 for all but the first frequency of a window), the pattern
// sums are at most 6 shared-memory adds per sample, and the P*k tails of a
// block run in sequence, each a handful of block barriers: latency, not
// bytes or FLOPs. The design mixes once per frequency and averages once per
// (frequency, pattern), as the Pallas kernel does, but without its one-hot
// extraction matmuls, lane-roll shifts or bf16 splits: a GPU gathers from
// shared memory directly.

#include "common.cuh"

namespace {

using namespace msk;

constexpr int kThreads = 256;
constexpr int kSmemBytes = 2 * kWindowLen * static_cast<int>(sizeof(float2));

__global__ void __launch_bounds__(kThreads)
demod_kernel(const float2* __restrict__ c, const float2* __restrict__ W,
             const int* __restrict__ pos, const float2* __restrict__ sync_conj,
             const float* __restrict__ pp12, const int* __restrict__ masks,
             const int* __restrict__ sync_pm, float* __restrict__ sb_out,
             int* __restrict__ nbad_out, int F, int P, int K) {
  extern __shared__ float2 smem[];
  float2* z = smem;                 // the mixed window
  float2* za = smem + kWindowLen;   // the current pattern's sum
  __shared__ TailSmem<kThreads> tail;

  const int cell = blockIdx.x;  // b * F + f
  const int b = cell / F;
  const int f = cell - b * F;
  const float2* cw = c + static_cast<size_t>(b) * kWindowLen;
  const float2* Wf = W + static_cast<size_t>(f) * kWindowLen;
  for (int t = threadIdx.x; t < kWindowLen; t += kThreads) z[t] = cmul(cw[t], Wf[t]);

  for (int p = 0; p < P; ++p) {
    __syncthreads();  // z written, or the previous pattern's tails done with za
    for (int t = threadIdx.x; t < kWindowLen; t += kThreads) {
      float2 acc = make_float2(0.f, 0.f);
      for (int m = 0; m < kFrames; ++m) {
        if (!masks[p * kFrames + m]) continue;
        int i = t + kFrameLen * m;
        if (i >= kWindowLen) i -= kWindowLen;
        acc = cadd(acc, z[i]);
      }
      za[t] = acc;
    }
    __syncthreads();
    for (int j = 0; j < K; ++j) {
      const size_t row = (static_cast<size_t>(cell) * P + p) * K + j;
      const int ps = pos[row];
      if (ps < 0 || ps >= kWindowLen) {
        // a lag outside the window: no read, the row can never survive
        if (threadIdx.x < 128) sb_out[row * 128 + threadIdx.x] = 0.f;
        if (threadIdx.x == 0) nbad_out[row] = 17;
        continue;
      }
      mf_tail<kThreads>(za, ps, kWindowLen, sync_conj, pp12, sync_pm, tail,
                        sb_out + row * 128, nbad_out + row);
    }
  }
}

}  // namespace

// Plain C interface (ctypes). Launches on `stream`; returns the first CUDA
// error of the shared-memory opt-in or the launch.
extern "C" int msk_demod(const void* c, const void* W, const void* pos, const void* sync_conj,
                         const void* pp12, const void* masks, const void* sync_pm,
                         void* sb_out, void* nbad_out, int n_win, int F, int P, int K,
                         void* stream) {
  if (n_win <= 0 || F <= 0 || P <= 0 || K <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(demod_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  demod_kernel<<<n_win * F, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(c), static_cast<const float2*>(W),
      static_cast<const int*>(pos), static_cast<const float2*>(sync_conj),
      static_cast<const float*>(pp12), static_cast<const int*>(masks),
      static_cast<const int*>(sync_pm), static_cast<float*>(sb_out),
      static_cast<int*>(nbad_out), F, P, K);
  return static_cast<int>(cudaGetLastError());
}
