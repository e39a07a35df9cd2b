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
// tail msk::warp_tail (common.cuh; kFast: mma_tail; both shared with B4):
// carrier phase, the 144 softbits, their scale and nbadsync. Every phase is
// a table value (W, chi, cb42), none an in-kernel sincos.
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
//
// kFast (DecoderConfig.fast_math; ops/precision.py, B2) rounds where the JAX
// kernel's fast mode does (pallas_survivor.py:107-109, 191-197, 285-296,
// 334-351): the block stages its window as bf16 pairs (half the bytes, 16
// bytes read a thread and step), the gamma lanes read W[f, 128q], W[f, r],
// W[f, 864m] and conj(1 + chi) rounded to bf16, form gamma in FP32 without
// fused multiply-adds (as the plain version) and round it; the mix and the
// pattern sum are in bf16; the carrier is W[f, 128j] W[f, r] in bf16 from a
// per-warp table of the 128 rounded W[f, r] and the 7 W[f, 128j] (in place
// of the cp.async of W[f, l]), and the frame times the carrier is in bf16.
// The bf16 arithmetic runs on packed pairs (common.cuh cmul_bf16, one
// rounding per instruction, equal bit for bit to the plain version's
// float32-then-round): a sample and frame of the mix costs one byte
// permute, two multiplies and two adds (gamma's two forms taken once per
// frame), and the 27 sums of a lane take 27 registers. The same arithmetic by float32 operations and a
// conversion after each was 3.3x the FP32 instantiation's time at the main
// path's 64 x 512 rows. The frame is exactly bf16, so the warp keeps it
// packed, one word a sample (4 KB with common.cuh frame_word's padding; the
// frame times the carrier stored as computed), and the tail is common.cuh
// mma_tail: the 144 softbits' 12-tap sums as one bf16 matrix product on
// the tensor cores (twelve mma.sync a row, B's fragments in one table per
// block), derotated after the taps, its mean and variance in any order.
// The window (20.7 KB) and eight warps' frames, stages and carrier tables
// take 63,488 bytes: three blocks, 24 warps per SM, at most 80 registers a
// thread. Measured slower (PERF.md section 6): two blocks per SM (128
// registers); a first tail of 18 mma.sync a row on rows of 12 samples (two
// of B's eight columns used), which spent a third of its time deriving
// each lane's few softbits.

#include "common.cuh"

namespace {

using namespace msk;

constexpr int kMaxWarps = 8;
constexpr int kStageBytes = kSoftbits * static_cast<int>(sizeof(float));
// kFast: W[f, r], r < 128, then the two forms (bf16_forms) of W[f, 128j], j < 7
constexpr int kCarrierTab = 128 + 2 * 7 + 2;  // (and a pad)
constexpr int kCarrierBytes = kCarrierTab * static_cast<int>(sizeof(unsigned));

// The window's bytes in shared memory: complex64, or packed bf16 pairs in kFast.
__host__ __device__ constexpr int window_bytes(bool fast) {
  return kWindowLen * static_cast<int>(fast ? sizeof(unsigned) : sizeof(float2));
}

// A warp's frame: complex64, or packed bf16 pairs in kFast (common.cuh
// frame_word).
__host__ __device__ constexpr int frame_bytes(bool fast) {
  return fast ? kPackedFrameWords * static_cast<int>(sizeof(unsigned))
              : kFrameLen * static_cast<int>(sizeof(float2));
}

// A block's shared memory: the window, the warps' frames, their tails'
// output staging and, in kFast, their carrier tables and the tails' B
// fragments (one table). kFast: 63,488 bytes at 8 warps, three blocks per SM.
constexpr int smem_bytes(bool fast, int warps) {
  return window_bytes(fast) +
         warps * (frame_bytes(fast) + kStageBytes + (fast ? kCarrierBytes : 0)) +
         (fast ? kTailBWords * static_cast<int>(sizeof(unsigned)) : 0);
}
static_assert(3 * (smem_bytes(true, kMaxWarps) + 1024) <= 233472, "three kFast blocks per SM");

// The mix and the pattern sum of one sample, window sample times gamma added
// to the lane's sum: in float32 (cadd(acc, cmul(src, g))), or in kFast on
// packed bf16 pairs (add_bf16x2(acc, cmul_bf16(src, gamma's forms))).
// word() is a lane's gamma as the warp shuffles it, take() frame m's from
// lane m.
template <bool kFast>
struct Mix;

template <>
struct Mix<false> {
  using Sample = float2;
  using Word = float2;
  using Gamma = float2;
  static __device__ __forceinline__ Sample zero() { return make_float2(0.f, 0.f); }
  static __device__ __forceinline__ Word word(float2 g) { return g; }
  static __device__ __forceinline__ Gamma take(Word w, int m) {
    return make_float2(__shfl_sync(0xffffffffu, w.x, m), __shfl_sync(0xffffffffu, w.y, m));
  }
  static __device__ __forceinline__ Sample mac(Sample acc, Sample src, Gamma g) {
    return cadd(acc, cmul(src, g));
  }
};

template <>
struct Mix<true> {
  using Sample = unsigned;
  using Word = unsigned;
  using Gamma = uint2;  // gamma's two forms (bf16_forms)
  static __device__ __forceinline__ Sample zero() { return 0u; }
  static __device__ __forceinline__ Word word(float2 g) { return pack_bf16(g); }
  static __device__ __forceinline__ Gamma take(Word w, int m) {
    return bf16_forms(__shfl_sync(0xffffffffu, w, m));
  }
  static __device__ __forceinline__ Sample mac(Sample acc, Sample src, Gamma g) {
    return add_bf16x2(acc, cmul_bf16(src, g));
  }
};

template <bool kFast>
__global__ void __launch_bounds__(32 * kMaxWarps, kFast ? 3 : 2)
survivor_kernel(const float2* __restrict__ c, const float2* __restrict__ W,
                const float2* __restrict__ chi, const int* __restrict__ pos,
                const int* __restrict__ f_idx, const int* __restrict__ p_idx,
                const float2* __restrict__ sync_conj, const float* __restrict__ pp12,
                const int* __restrict__ masks, const int* __restrict__ sync_pm,
                float* __restrict__ sb_out, int* __restrict__ nbad_out, int S, int F,
                int rows_per_block) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  float2* win = reinterpret_cast<float2*>(smem);  // the window, once per block
  unsigned* winb = reinterpret_cast<unsigned*>(smem);  // kFast's, packed bf16
  // this warp's frame: float2 (frame), or packed bf16 in kFast (fr)
  char* frame_base = smem + window_bytes(kFast) + warp * frame_bytes(kFast);
  float2* frame = reinterpret_cast<float2*>(frame_base);
  unsigned* fr = reinterpret_cast<unsigned*>(frame_base);
  const float2* cw = c + static_cast<size_t>(b) * kWindowLen;
  float pp[12];
  MmaTaps taps;
  if constexpr (kFast)
    taps = load_mma_taps(sync_conj, sync_pm);
  else
    load_taps(pp12, pp);
  // the tail's output staging, after the frames; kFast's carrier table after it
  float* stage = reinterpret_cast<float*>(smem + window_bytes(kFast) +
                                          warps * frame_bytes(kFast)) +
                 warp * kSoftbits;
  unsigned* ctab = reinterpret_cast<unsigned*>(smem + window_bytes(kFast) +
                                               warps * (frame_bytes(kFast) + kStageBytes)) +
                   warp * kCarrierTab;
  // kFast: the tails' B fragments, after the carrier tables
  unsigned* tail_b = reinterpret_cast<unsigned*>(
      smem + window_bytes(kFast) + warps * (frame_bytes(kFast) + kStageBytes + kCarrierBytes));
  if constexpr (kFast) {  // two samples a thread and step, 16 bytes read, 8 written
    const float4* cw4 = reinterpret_cast<const float4*>(cw);
    uint2* winb2 = reinterpret_cast<uint2*>(winb);
#pragma unroll 4
    for (int t = threadIdx.x; t < kWindowLen / 2; t += blockDim.x) {
      const float4 v = __ldg(cw4 + t);
      winb2[t] = make_uint2(pack_bf16(make_float2(v.x, v.y)), pack_bf16(make_float2(v.z, v.w)));
    }
    store_tail_b(pp12, tail_b);
    if (lane < kFrameWords - kFrameLead - kFrameLen)  // the frame's two zero pads
      fr[frame_word(kFrameLead + kFrameLen + lane)] = 0u;
  } else {
    for (int t = threadIdx.x; t < kWindowLen; t += blockDim.x) cp_async8(win + t, cw + t);
  }

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
    if constexpr (kFast) {  // the carrier's table values, rounded
      for (int r = lane; r < 128; r += 32) ctab[r] = pack_bf16(Wf[r]);
      if (lane < 7)
        reinterpret_cast<uint2*>(ctab + 128)[lane] = bf16_forms(pack_bf16(Wf[128 * lane]));
    } else {
      for (int l = lane; l < kFrameLen; l += 32) cp_async8(frame + l, Wf + l);  // W[f, l]
    }

    // gamma[m, 0..1] on lane m < 6; the warp takes frame m's by shuffle
    float2 g0 = make_float2(0.f, 0.f), g1 = g0;
    int mk = 0;
    if (lane < kFrames) {
      mk = masks[p_c * kFrames + lane];
      const float2 ch = chi[f_c];
      const float2 phi = make_float2(1.f + ch.x, -ch.y);  // conj(1 + chi)
      const float2 m = make_float2(static_cast<float>(mk), 0.f);
      if constexpr (kFast) {  // g0, g1 rounded to bf16 when packed below
        const float2 w_pos = cmul_rn(round_bf16(Wf[128 * (ps_c / 128)]), round_bf16(Wf[ps_c % 128]));
        g0 = cmul_rn(cmul_rn(m, w_pos), round_bf16(Wf[kFrameLen * lane]));
        g1 = cmul_rn(g0, round_bf16(phi));
      } else {
        const float2 w_pos = cmul(Wf[128 * (ps_c / 128)], Wf[ps_c % 128]);
        g0 = cmul(cmul(m, w_pos), Wf[kFrameLen * lane]);
        g1 = cmul(g0, phi);
      }
    }
    const unsigned active = __ballot_sync(0xffffffffu, mk != 0);

    // the frame's 27 samples of this lane, l = lane + 32n, summed in
    // registers over the active frames in ascending m (a zero gamma would
    // add an exact zero, so inactive frames are skipped); a frame's samples
    // wrap (pos + 864m + l >= N, gamma[m, 1]) for none, all or a suffix of l
    using P = Mix<kFast>;
    const typename P::Sample* wsrc = reinterpret_cast<const typename P::Sample*>(smem);
    const typename P::Word w0 = P::word(g0), w1 = P::word(g1);
    typename P::Sample acc[kFrameLen / 32];
#pragma unroll
    for (int n = 0; n < kFrameLen / 32; ++n) acc[n] = P::zero();
#pragma unroll
    for (int m = 0; m < kFrames; ++m) {
      if (!(active >> m & 1u)) continue;
      const typename P::Gamma ga = P::take(w0, m), gb = P::take(w1, m);
      const int start = ps_c + kFrameLen * m;
      if (start + kFrameLen <= kWindowLen) {
        const typename P::Sample* src = wsrc + start + lane;
#pragma unroll
        for (int n = 0; n < kFrameLen / 32; ++n) acc[n] = P::mac(acc[n], src[32 * n], ga);
      } else if (start >= kWindowLen) {
        const typename P::Sample* src = wsrc + start - kWindowLen + lane;
#pragma unroll
        for (int n = 0; n < kFrameLen / 32; ++n) acc[n] = P::mac(acc[n], src[32 * n], gb);
      } else {
#pragma unroll
        for (int n = 0; n < kFrameLen / 32; ++n) {
          const int idx = start + lane + 32 * n;
          const bool wrap = idx >= kWindowLen;
          acc[n] = P::mac(acc[n], wsrc[wrap ? idx - kWindowLen : idx], wrap ? gb : ga);
        }
      }
    }

    // times the carrier W[f, l]
    if constexpr (kFast) {
      __syncwarp();  // the carrier table is written
#pragma unroll
      for (int n = 0; n < kFrameLen / 32; ++n) {
        const int l = lane + 32 * n;  // W[f, l] = W[f, 128j] W[f, r], l = 128j + r, in bf16
        const unsigned car =
            cmul_bf16(ctab[l & 127], reinterpret_cast<const uint2*>(ctab + 128)[l >> 7]);
        const unsigned v = cmul_bf16(acc[n], bf16_forms(car));
        fr[frame_word(kFrameLead + l)] = v;
        if (n == kFrameLen / 32 - 1 && l >= kFrameLen - kFrameLead)  // words 0-5 repeat 858-863
          fr[l - (kFrameLen - kFrameLead)] = v;
      }
    } else {
      cp_async_wait_all();  // each lane reads back only the W[f, l] it copied
#pragma unroll
      for (int n = 0; n < kFrameLen / 32; ++n) {
        const int l = lane + 32 * n;
        frame[l] = cmul(acc[n], frame[l]);
      }
    }
    __syncwarp();

    // the matched-filter tail
    if constexpr (kFast)
      mma_tail(PackedFrame(fr), tail_b, taps, stage, sb_out + row * 128, nbad_out + row);
    else
      warp_tail(frame, sync_conj, pp, sync_pm, stage, sb_out + row * 128, nbad_out + row);
    __syncwarp();  // every lane is done with the frame before the next row's copy
  }
}

template <bool kFast>
cudaError_t launch(const void* c, const void* W, const void* chi, const void* pos,
                   const void* f_idx, const void* p_idx, const void* sync_conj,
                   const void* pp12, const void* masks, const void* sync_pm, void* sb_out,
                   void* nbad_out, int n_win, int S, int F, int rows_per_block,
                   cudaStream_t stream) {
  const int warps = rows_per_block < kMaxWarps ? rows_per_block : kMaxWarps;
  const int smem = smem_bytes(kFast, warps);
  // once per device, the opt-in for the widest block (8 warps)
  static std::atomic<unsigned long long> done{0};
  const cudaError_t err = opt_in_once(done, [] {
    return cudaFuncSetAttribute(survivor_kernel<kFast>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem_bytes(kFast, kMaxWarps));
  });
  if (err != cudaSuccess) return err;
  const dim3 grid((S + rows_per_block - 1) / rows_per_block, n_win);
  survivor_kernel<kFast><<<grid, 32 * warps, smem, stream>>>(
      static_cast<const float2*>(c), static_cast<const float2*>(W),
      static_cast<const float2*>(chi), static_cast<const int*>(pos),
      static_cast<const int*>(f_idx), static_cast<const int*>(p_idx),
      static_cast<const float2*>(sync_conj), static_cast<const float*>(pp12),
      static_cast<const int*>(masks), static_cast<const int*>(sync_pm),
      static_cast<float*>(sb_out), static_cast<int*>(nbad_out), S, F, rows_per_block);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface (ctypes). Launches on `stream`: blocks of
// rows_per_block rows of one window, on min(rows_per_block, 8) warps; fast
// != 0: the kFast instantiation. Returns the first CUDA error of the
// shared-memory opt-in or the launch.
extern "C" int msk_survivor(const void* c, const void* W, const void* chi, const void* pos,
                            const void* f_idx, const void* p_idx, const void* sync_conj,
                            const void* pp12, const void* masks, const void* sync_pm,
                            void* sb_out, void* nbad_out, int n_win, int S, int F,
                            int rows_per_block, int fast, void* stream) {
  if (n_win <= 0 || S <= 0) return 0;
  if (rows_per_block < 1 || n_win > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const auto run = fast ? launch<true> : launch<false>;
  return static_cast<int>(run(c, W, chi, pos, f_idx, p_idx, sync_conj, pp12, masks, sync_pm,
                              sb_out, nbad_out, n_win, S, F, rows_per_block,
                              static_cast<cudaStream_t>(stream)));
}
