// Kernel B4: the full demod of every scan candidate (survivor_prefilter=0).
//
// Replaces msk144cudecoder_tpu/ops/pallas_demod.py::_demod_kernel (launched
// by demod_pallas) and its tail mf_tail. Same result as the plain torch
// version softbits.demod_candidates (ops/demod.py, demod_candidates_plain).
//
// One block of 9 warps per (window b, frequency f), all B*F blocks in one
// launch:
//   z[t]    = c[t] * W[f, t]                                   t < N
//   ZA_p[t] = sum_{m ascending, mask_p[m]} z[(t + 864m) mod N]  per pattern p
// z lives in registers by columns: thread j holds z at col + 864m (m < 6)
// for its columns col = j, j + 288, j + 576, so the window and W[f] are read
// once per block, and ZA_p at col + 864r is the sum of z[col + 864((r + m)
// mod 6)] over the pattern's frames m. ZA_p lives in shared memory (with a
// copy of its first 864 samples after it, so that a frame at any lag reads
// without a wrap) and is built incrementally, in the order of
// softbits.pattern_average: where pattern p holds every frame of pattern
// p - 1 and its new frames all come after them (the prefix patterns 1-5, and
// 7 = 6 + {4}), ZA_p = ZA_{p-1} + its new frames, in place; otherwise (0, and
// 6 = {0, 3}) ZA_p is summed from 0. Either way the frames are added in
// ascending m, so ZA_p is bit for bit the plain ascending-m sum (0 + z = z
// exactly): one add per sample per new frame, not up to six per pattern. The
// plan comes from the masks, so any table of patterns sums right. Then the
// k <= 8 candidates of the pattern run at once, one warp each, through the
// warp-level matched-filter tail msk::warp_tail (common.cuh, shared with
// kernel B2) on ZA_p + pos.
//
// What bounds it on the H100: not bytes or FLOPs (the softbits it writes,
// 512 bytes a row, are the largest traffic) but latency: each tail is a
// chain of dependent shared-memory loads and warp shuffles, and the pattern
// sums need two block barriers per pattern (the update waits for the
// previous pattern's tails). The first port ran the P*k tails of a block one
// after another, each on the whole block with six barriers (48 x 6 at the
// deep scan) and 144 of 256 threads busy, and rebuilt each pattern sum from
// up to six frames in shared memory beside z (83 KB, 2 blocks per SM). Here
// a pattern's tails run side by side, the update is a few register adds per
// sample, and the block holds only ZA and the tails' output staging (52 KB):
// three blocks (27 warps, 24 tails at once) per SM, the register budget that
// fits them capped by __launch_bounds__. Measured slower on the H100: z
// recomputed from L2 at each update (W[f] then crosses L2 six times per
// block), z in shared memory beside ZA (2 blocks per SM), two ZA buffers with
// one barrier per pattern (2 blocks per SM), four blocks per SM (register
// spills), and the taps' weights in __constant__ memory.
//
// kFast (DecoderConfig.fast_math; ops/precision.py, B4) changes only the
// matched filter, as the JAX kernel's fast mode (pallas_demod.py:159-160,
// 275-276): its operands, the float32 pattern sums and the taps, are
// rounded once to bf16, and every sum is float32. So kFast keeps no float32
// sum in shared memory, only each sum rounded and packed as a bf16 pair
// (pack_bf16), and runs the tails on the tensor cores: a block of 27 warps
// per (b, f), thread j holding column j (z at j + 864m, 12 registers),
// builds its column of every pattern's sum in registers by the float32
// kernel's plan (the same sums, bit for bit), and stores all P packed sums
// at once (6052 words each, samples 0-864 again after N, so that no frame
// wraps: 145 KB at depth 6, one block per SM); after one block barrier the
// P*k tails run on the 27 warps with no further barrier, each common.cuh
// mma_tail on a LagFrame: the 144 softbits' 12-tap sums as one bf16 matrix
// product (12 mma.sync a row) read straight from the packed sum at the
// candidate's lag. Measured slower on the H100 (times in PERF.md section
// 6): nine warps per cell, each thread summing its three columns of a
// pattern from 0 and packing them, two packed buffers (registers spill);
// the float32 kernel's sums in shared memory, each fragment word rounded as
// it is read; a block per SM looping over the cells, the next cell's
// window loaded during the tails (spills). Two blocks per cell, each with
// half the patterns and two columns a thread, measured no faster.

#include "common.cuh"

namespace {

using namespace msk;

// ZA_p and a copy of its first 864 samples after it: 48,384 bytes
constexpr int kSumLen = kWindowLen + kFrameLen;

__device__ __forceinline__ unsigned pattern_bits(const int* __restrict__ masks, int p) {
  unsigned want = 0;
#pragma unroll
  for (int m = 0; m < kFrames; ++m) want |= (masks[p * kFrames + m] != 0 ? 1u : 0u) << m;
  return want;
}

// The frames pattern `want` adds to the held sum: when the held frames are a
// subset of want and every new frame comes after the last held one, the new
// ones (extend = true); else all of want, summed from 0.
__device__ __forceinline__ unsigned frames_to_add(unsigned held, unsigned want, bool& extend) {
  const unsigned fresh = want & ~held;
  extend = held != 0 && (held & ~want) == 0 && (fresh & ((2u << (31 - __clz(held))) - 1u)) == 0;
  return extend ? fresh : want;
}

__device__ __forceinline__ float2 add_rn(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

constexpr int kThreads = 288;  // thread j holds columns j, j + 288, j + 576
constexpr int kWarps = kThreads / 32;

// kFast: thread j holds column j; a packed pattern sum is 6052 words
constexpr int kFastThreads = kFrameLen;
constexpr int kFastWarps = kFastThreads / 32;
constexpr int kPackLen = (kWindowLen + kFrameLen + 1 + 3) & ~3;

// The threads, and so the columns a thread holds, of an instantiation
__host__ __device__ constexpr int block_threads(bool fast) { return fast ? kFastThreads : kThreads; }

// kFast's sums and tails, after z: this thread's column of every pattern
// summed in registers by the float32 kernel's plan (frames_to_add, in
// ascending m), each sample rounded once to bf16 and stored packed at word
// col + 864 r of the pattern's buffer (samples 0-864 again after N); then
// the block's P*K tails on its 27 warps, a warp's next lag loaded during its
// tail.
__device__ __forceinline__ void fast_tails(const float2 (&z)[kFrames], const int* __restrict__ pos,
                                           const float2* __restrict__ sync_conj,
                                           const float* __restrict__ pp12,
                                           const int* __restrict__ masks,
                                           const int* __restrict__ sync_pm,
                                           float* __restrict__ sb_out,
                                           int* __restrict__ nbad_out, int cell, int P, int K) {
  extern __shared__ float4 smem4[];
  unsigned* const zp = reinterpret_cast<unsigned*>(smem4);  // P packed pattern sums
  const int warp = threadIdx.x >> 5;
  const int col = threadIdx.x;
  float* stage = reinterpret_cast<float*>(zp + P * kPackLen) + warp * kSoftbits;  // the tail's
  unsigned* tail_b = reinterpret_cast<unsigned*>(zp + P * kPackLen) + kFastWarps * kSoftbits;
  store_tail_b(pp12, tail_b);
  const MmaTaps taps = load_mma_taps(sync_conj, sync_pm);
  const int rows = P * K;
  const size_t row0 = static_cast<size_t>(cell) * rows;  // row (cell, p, j) = row0 + p K + j
  int ps_next = warp < rows ? pos[row0 + warp] : 0;
  // the frames of every pattern, bit 6 p + m, by two ballots
  const int lane = threadIdx.x & 31;
  const unsigned long long frames =
      __ballot_sync(0xffffffffu, lane < kFrames * P && masks[lane] != 0) |
      static_cast<unsigned long long>(
          __ballot_sync(0xffffffffu, lane + 32 < kFrames * P && masks[lane + 32] != 0))
          << 32;

  float2 acc[kFrames];
  unsigned held = 0;
  for (int p = 0; p < P; ++p) {
    const unsigned want = static_cast<unsigned>(frames >> (kFrames * p)) & 63u;
    bool extend;
    const unsigned add = frames_to_add(held, want, extend);
    held = want;
#pragma unroll
    for (int r = 0; r < kFrames; ++r)
      if (!extend) acc[r] = make_float2(0.f, 0.f);
#pragma unroll
    for (int m = 0; m < kFrames; ++m) {
      if (!(add >> m & 1u)) continue;
#pragma unroll
      for (int r = 0; r < kFrames; ++r) acc[r] = add_rn(acc[r], z[(r + m) % kFrames]);
    }
    unsigned* za = zp + p * kPackLen;
#pragma unroll
    for (int r = 0; r < kFrames; ++r) za[col + kFrameLen * r] = pack_bf16(acc[r]);
    za[kWindowLen + col] = pack_bf16(acc[0]);
    if (col == 0) za[kWindowLen + kFrameLen] = pack_bf16(acc[1]);
  }
  __syncthreads();

  for (int t = warp; t < rows; t += kFastWarps) {
    const size_t row = row0 + t;
    const int ps = ps_next;
    if (t + kFastWarps < rows) ps_next = pos[row + kFastWarps];
    if (ps < 0 || ps >= kWindowLen) {
      // a lag outside the window: no read, the row can never survive
      warp_reject(sb_out + row * 128, nbad_out + row);
      continue;
    }
    mma_tail(LagFrame(zp + (t / K) * kPackLen, ps), tail_b, taps, stage, sb_out + row * 128,
             nbad_out + row);
  }
}

template <bool kFast>
__global__ void __launch_bounds__(block_threads(kFast), kFast ? 1 : 3)
demod_kernel(const float2* __restrict__ c, const float2* __restrict__ W,
             const int* __restrict__ pos, const float2* __restrict__ sync_conj,
             const float* __restrict__ pp12, const int* __restrict__ masks,
             const int* __restrict__ sync_pm, float* __restrict__ sb_out,
             int* __restrict__ nbad_out, int F, int P, int K) {
  extern __shared__ float4 smem4[];
  float2* const za = reinterpret_cast<float2*>(smem4);  // ZA_p, za[N + l] = za[l], l < 864

  const int cell = blockIdx.x;  // b * F + f
  const int b = cell / F;
  const int f = cell - b * F;
  const int warp = threadIdx.x >> 5;
  const float2* cw = c + static_cast<size_t>(b) * kWindowLen;
  const float2* Wf = W + static_cast<size_t>(f) * kWindowLen;
  constexpr int kCols = kFrameLen / block_threads(kFast);
  float2 zc[kCols][kFrames];
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
#pragma unroll
    for (int m = 0; m < kFrames; ++m) {
      const int i = threadIdx.x + block_threads(kFast) * k + kFrameLen * m;
      zc[k][m] = cmul(cw[i], Wf[i]);
    }
  }
  if constexpr (kFast) {
    fast_tails(zc[0], pos, sync_conj, pp12, masks, sync_pm, sb_out, nbad_out, cell, P, K);
    return;
  }
  float pp[12];
  load_taps(pp12, pp);
  float* stage = reinterpret_cast<float*>(za + kSumLen) + warp * kSoftbits;  // the tail's

  unsigned held = 0;
  for (int p = 0; p < P; ++p) {
    const unsigned want = pattern_bits(masks, p);
    bool extend;
    const unsigned add = frames_to_add(held, want, extend);
    held = want;

    __syncthreads();  // the previous pattern's tails are done with za
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int col = threadIdx.x + kThreads * k;
      float2 acc[kFrames];
#pragma unroll
      for (int r = 0; r < kFrames; ++r)
        acc[r] = extend ? za[col + kFrameLen * r] : make_float2(0.f, 0.f);
#pragma unroll
      for (int m = 0; m < kFrames; ++m) {
        if (!(add >> m & 1u)) continue;
#pragma unroll
        for (int r = 0; r < kFrames; ++r) acc[r] = add_rn(acc[r], zc[k][(r + m) % kFrames]);
      }
#pragma unroll
      for (int r = 0; r < kFrames; ++r) za[col + kFrameLen * r] = acc[r];
      za[kWindowLen + col] = acc[0];
    }
    __syncthreads();

    for (int j = warp; j < K; j += kWarps) {
      const size_t row = (static_cast<size_t>(cell) * P + p) * K + j;
      const int ps = pos[row];
      if (ps < 0 || ps >= kWindowLen) {
        // a lag outside the window: no read, the row can never survive
        warp_reject(sb_out + row * 128, nbad_out + row);
        continue;
      }
      warp_tail(za + ps, sync_conj, pp, sync_pm, stage, sb_out + row * 128, nbad_out + row);
    }
  }
}

// ZA_p with its copy, then the tails' output staging: 53,568 bytes, three
// blocks per SM; kFast: P packed pattern sums, the staging and the tails' B
// fragments, 161,824 bytes at depth 6 and 210,240 at depth 8, one block
constexpr int kSmemBytes = kSumLen * sizeof(float2) + kWarps * kSoftbits * sizeof(float);
static_assert(3 * (kSmemBytes + 1024) <= 233472, "three float32 blocks per SM");

constexpr int fast_smem_bytes(int P) {
  return (P * kPackLen + kFastWarps * kSoftbits + kTailBWords) * static_cast<int>(sizeof(unsigned));
}
static_assert(fast_smem_bytes(8) <= 232448, "kFast at depth 8 in one block");

template <bool kFast>
cudaError_t launch(const void* c, const void* W, const void* pos, const void* sync_conj,
                   const void* pp12, const void* masks, const void* sync_pm, void* sb_out,
                   void* nbad_out, int n_win, int F, int P, int K, cudaStream_t stream) {
  // once per device: the most shared memory per SM, so that three blocks
  // (kFast: one) fit, and the opt-in for the largest block (kFast: depth 8)
  static std::atomic<unsigned long long> done{0};
  const cudaError_t err = opt_in_once(done, [] {
    cudaError_t e = cudaFuncSetAttribute(demod_kernel<kFast>,
                                         cudaFuncAttributePreferredSharedMemoryCarveout,
                                         cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(demod_kernel<kFast>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kFast ? fast_smem_bytes(8) : kSmemBytes);
    return e;
  });
  if (err != cudaSuccess) return err;
  const int smem = kFast ? fast_smem_bytes(P) : kSmemBytes;
  demod_kernel<kFast><<<n_win * F, block_threads(kFast), smem, stream>>>(
      static_cast<const float2*>(c), static_cast<const float2*>(W),
      static_cast<const int*>(pos), static_cast<const float2*>(sync_conj),
      static_cast<const float*>(pp12), static_cast<const int*>(masks),
      static_cast<const int*>(sync_pm), static_cast<float*>(sb_out),
      static_cast<int*>(nbad_out), F, P, K);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface (ctypes). Launches on `stream`; fast != 0: the kFast
// instantiation. Returns the first CUDA error of the shared-memory
// attributes or the launch; more than 8 patterns (kFast holds all of a
// cell's in shared memory): cudaErrorInvalidValue.
extern "C" int msk_demod(const void* c, const void* W, const void* pos, const void* sync_conj,
                         const void* pp12, const void* masks, const void* sync_pm,
                         void* sb_out, void* nbad_out, int n_win, int F, int P, int K,
                         int fast, void* stream) {
  if (n_win <= 0 || F <= 0 || P <= 0 || K <= 0) return 0;
  if (P > 8) return static_cast<int>(cudaErrorInvalidValue);
  const auto run = fast ? launch<true> : launch<false>;
  return static_cast<int>(run(c, W, pos, sync_conj, pp12, masks, sync_pm, sb_out, nbad_out,
                              n_win, F, P, K, static_cast<cudaStream_t>(stream)));
}
