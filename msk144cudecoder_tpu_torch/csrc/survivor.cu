// Kernel B2: the survivor demod.
//
// Replaces msk144cudecoder_tpu/ops/pallas_survivor.py::_survivor_kernel
// (launched by demod_survivors, operands from survivor_params) and its tail
// ops/pallas_demod.py::mf_tail. Same result as the plain torch version in
// ops/survivor.py (demod_survivors_plain).
//
// Per survivor row (window b, survivor s), all B*S rows in one launch, each
// row with its own pattern p:
//   gamma[m, 0]   = mask_p[m] * (W[f, 128*(pos/128)] * W[f, pos%128]) * W[f, 864m]
//   gamma[m, 1]   = gamma[m, 0] * conj(1 + chi_f)
//   frame[l] = (sum_m c[(pos + 864m + l) mod N] * gamma[m, k]) * W[f, l],
//              k = (pos + 864m + l) >= N,  l < 864
// (pos < N and 864m + l < N, so k <= 1), then the warp-level matched-filter
// tail msk::warp_tail (common.cuh, shared with kernel B4): carrier phase, the
// 144 softbits, their scale and nbadsync. Every phase is a table value (W,
// chi, cb42), none an in-kernel sincos.
//
// What bounds it on the H100: per row about 3-6 x 864 complex reads of the
// window (41 KB, shared by the window's 512 rows) and a few thousand FLOPs,
// so latency and the window's reads, not bytes or FP32 issue. The first port
// gave each row a 256-thread block that read the window through L1/L2 (each
// SM meets a window only a block or two at a time, so mostly L2), with 144
// threads busy in the tail and six block barriers. Here a block of up to 8
// warps takes rows_per_block consecutive rows of ONE window (rows b*S + s),
// stages the window once into shared memory (cp.async), and each warp runs
// its rows one by one with no block barrier: lanes 0-5 build gamma and the
// warp takes it by shuffle; each lane sums its 27 frame samples in
// registers over the active frames in ascending m (a frame's wrap is
// none, all or a suffix of l, so the common cases need no per-sample
// select), W[f, l] arriving meanwhile by cp.async into the warp's 6.9 KB
// frame buffer; the tail reduces by shuffles and ballots. The next row's
// indices are loaded during the current one. A ragged last block runs fewer
// rows. The window plus eight frames and the tails' 576-byte output
// staging take 99 KB, two blocks per SM. Measured slower on the H100: the
// window read through L1 (a warp per row, no staging), frames padded
// against bank conflicts (the index arithmetic cost more than the
// conflicts), ten warps per block, and the taps' weights in __constant__
// memory.

#include "common.cuh"

namespace {

using namespace msk;

constexpr int kMaxWarps = 8;
constexpr int kWindowBytes = kWindowLen * static_cast<int>(sizeof(float2));
constexpr int kFrameBytes = kFrameLen * static_cast<int>(sizeof(float2));

__global__ void __launch_bounds__(32 * kMaxWarps, 2)
survivor_kernel(const float2* __restrict__ c, const float2* __restrict__ W,
                const float2* __restrict__ chi, const int* __restrict__ pos,
                const int* __restrict__ f_idx, const int* __restrict__ p_idx,
                const float2* __restrict__ sync_conj, const float* __restrict__ pp12,
                const int* __restrict__ masks, const int* __restrict__ sync_pm,
                float* __restrict__ sb_out, int* __restrict__ nbad_out, int S, int F,
                int rows_per_block) {
  extern __shared__ float4 smem4[];
  float2* smem = reinterpret_cast<float2*>(smem4);
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  float2* win = smem;                                      // the window, once per block
  float2* frame = smem + kWindowLen + warp * kFrameLen;  // this warp's frame
  const float2* cw = c + static_cast<size_t>(b) * kWindowLen;
  float pp[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) pp[i] = pp12[i];
  // the tail's output staging, after the frames
  float* stage =
      reinterpret_cast<float*>(smem + kWindowLen + warps * kFrameLen) + warp * kSoftbits;
  for (int t = threadIdx.x; t < kWindowLen; t += blockDim.x) cp_async8(win + t, cw + t);

  // a row's indices are loaded one row ahead
  const int s_end = min(S, (blockIdx.x + 1) * rows_per_block);
  const size_t row_base = static_cast<size_t>(b) * S;
  int s = blockIdx.x * rows_per_block + warp;
  int ps = 0, f = 0, p = 0;
  if (s < s_end) {
    ps = pos[row_base + s];
    f = f_idx[row_base + s];
    p = p_idx[row_base + s];
  }
  cp_async_wait_all();
  __syncthreads();

  for (; s < s_end; s += warps) {
    const size_t row = row_base + s;
    const int ps_c = ps, f_c = f, p_c = p;
    if (s + warps < s_end) {
      ps = pos[row + warps];
      f = f_idx[row + warps];
      p = p_idx[row + warps];
    }
    if (ps_c < 0 || ps_c >= kWindowLen || f_c < 0 || f_c >= F || p_c < 0 || p_c >= 8) {
      // an index outside the tables: no read, the row can never survive
      warp_reject(sb_out + row * 128, nbad_out + row);
      continue;
    }
    const float2* Wf = W + static_cast<size_t>(f_c) * kWindowLen;
    for (int l = lane; l < kFrameLen; l += 32) cp_async8(frame + l, Wf + l);  // W[f, l]

    // gamma[m, 0..1] on lane m < 6; the warp takes frame m's by shuffle
    float2 g0 = make_float2(0.f, 0.f), g1 = g0;
    int mk = 0;
    if (lane < kFrames) {
      mk = masks[p_c * kFrames + lane];
      const float2 w_pos = cmul(Wf[128 * (ps_c / 128)], Wf[ps_c % 128]);
      const float2 ch = chi[f_c];
      const float2 phi = make_float2(1.f + ch.x, -ch.y);  // conj(1 + chi)
      g0 = cmul(cmul(make_float2(static_cast<float>(mk), 0.f), w_pos), Wf[kFrameLen * lane]);
      g1 = cmul(g0, phi);
    }
    const unsigned active = __ballot_sync(0xffffffffu, mk != 0);

    // the frame's 27 samples of this lane, l = lane + 32n, summed in
    // registers over the active frames in ascending m (a zero gamma would
    // add an exact zero, so inactive frames are skipped); a frame's samples
    // wrap (pos + 864m + l >= N, gamma[m, 1]) for none, all or a suffix of l
    float2 acc[kFrameLen / 32];
#pragma unroll
    for (int n = 0; n < kFrameLen / 32; ++n) acc[n] = make_float2(0.f, 0.f);
#pragma unroll
    for (int m = 0; m < kFrames; ++m) {
      if (!(active >> m & 1u)) continue;
      const float2 ga = make_float2(__shfl_sync(0xffffffffu, g0.x, m),
                                    __shfl_sync(0xffffffffu, g0.y, m));
      const float2 gb = make_float2(__shfl_sync(0xffffffffu, g1.x, m),
                                    __shfl_sync(0xffffffffu, g1.y, m));
      const int start = ps_c + kFrameLen * m;
      if (start + kFrameLen <= kWindowLen) {
        const float2* src = win + start + lane;
#pragma unroll
        for (int n = 0; n < kFrameLen / 32; ++n) acc[n] = cadd(acc[n], cmul(src[32 * n], ga));
      } else if (start >= kWindowLen) {
        const float2* src = win + start - kWindowLen + lane;
#pragma unroll
        for (int n = 0; n < kFrameLen / 32; ++n) acc[n] = cadd(acc[n], cmul(src[32 * n], gb));
      } else {
#pragma unroll
        for (int n = 0; n < kFrameLen / 32; ++n) {
          const int idx = start + lane + 32 * n;
          const bool wrap = idx >= kWindowLen;
          acc[n] = cadd(acc[n], cmul(win[wrap ? idx - kWindowLen : idx], wrap ? gb : ga));
        }
      }
    }

    cp_async_wait_all();  // each lane reads back only the W[f, l] it copied
#pragma unroll
    for (int n = 0; n < kFrameLen / 32; ++n) {
      const int l = lane + 32 * n;
      frame[l] = cmul(acc[n], frame[l]);
    }
    __syncwarp();

    warp_tail(frame, sync_conj, pp, sync_pm, stage, sb_out + row * 128, nbad_out + row);
    __syncwarp();  // every lane is done with the frame before the next row's copy
  }
}

}  // namespace

// Plain C interface (ctypes). Launches on `stream`: blocks of
// rows_per_block rows of one window, on min(rows_per_block, 8) warps.
// Returns the first CUDA error of the shared-memory opt-in or the launch.
extern "C" int msk_survivor(const void* c, const void* W, const void* chi, const void* pos,
                            const void* f_idx, const void* p_idx, const void* sync_conj,
                            const void* pp12, const void* masks, const void* sync_pm,
                            void* sb_out, void* nbad_out, int n_win, int S, int F,
                            int rows_per_block, void* stream) {
  if (n_win <= 0 || S <= 0) return 0;
  if (rows_per_block < 1 || n_win > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int warps = rows_per_block < kMaxWarps ? rows_per_block : kMaxWarps;
  const int smem =
      kWindowBytes + warps * (kFrameBytes + kSoftbits * static_cast<int>(sizeof(float)));
  cudaError_t err = cudaFuncSetAttribute(survivor_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + rows_per_block - 1) / rows_per_block, n_win);
  survivor_kernel<<<grid, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(c), static_cast<const float2*>(W),
      static_cast<const float2*>(chi), static_cast<const int*>(pos),
      static_cast<const int*>(f_idx), static_cast<const int*>(p_idx),
      static_cast<const float2*>(sync_conj), static_cast<const float*>(pp12),
      static_cast<const int*>(masks), static_cast<const int*>(sync_pm),
      static_cast<float*>(sb_out), static_cast<int*>(nbad_out), S, F, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}
