// Kernel B1: the wideband sync scan.
//
// Replaces msk144cudecoder_tpu/ops/pallas_scan.py::_scan_kernel (launched by
// scan_pallas) in two instantiations: float32 (scan_kernel) and the bf16
// fast_math policy (scan_fast_kernel; ops/precision.py, B1). Same result as
// the plain torch version in ops/scan.py (scan_plain), with the JAX jnp
// scan's exact-f32 tie order, not the Pallas kernel's packed keys.
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
// One block of 256 threads per (window, tile of frequencies). The two
// instantiations differ only in how they stage the window and compute the
// correlation; both then call the same device functions: the wrap
// correction R + chi * D, the phase ramp G = E * R into shared memory
// (freq-major, G[ft * N/dec + l']), G in place becoming H[l] = G[l] +
// G[l + 336/dec] (the frame's two sync words, so that T_m(l) = G[l +
// 864m/dec] + G[l + (864m + 336)/dec] = H[l + 864m/dec] with the same
// rounding), every pattern's (max, first argmax) per slice from T_m built
// once per lag (16 or 32 lanes per slice, shuffles), and the top-k of the
// 21 slice maxima as a rank (one warp per (f, p), a lane per slice).
//
// float32 (scan_kernel). What bounds it on the H100: FP32 work, not device
// memory. Per (window, f) the correlation is 42 complex multiply-adds at
// each of N/dec lags (about 0.44 MFLOP at dec 4, with the pattern sums and
// magnitudes about 0.5), so a batch of 64 windows at F = 101 is 3.2 GFLOP,
// 0.048 ms at 67 TFLOP/s, while it reads 2.7 MB. The design: tiles of FT in
// {1, 2, 4} frequencies, at most dec, chosen by the wrapper (scan_tile) so
// that the grid still fills the SMs; the window staged once per block with
// 16-byte loads in polyphase order (sample s at (s mod dec) * N/dec +
// s / dec), so that the lanes of a warp read consecutive words at every tap;
// each thread holds all its 20/dec lags x FT frequencies of complex sums in
// registers (20 at most): every sample read feeds FT products and every tap
// (a broadcast) 20/dec; taps in order 0..41 for every output, the lags whose
// taps wrap (one per thread of the first FT * 64/dec) in the R + chi * D
// form, so G is the per-lag loop's up to the sign of an exact zero. G then
// takes the window's place: at most 48 KB of dynamic shared memory, no
// opt-in, four blocks (32 warps) per SM.
//
// kFast (scan_fast_kernel): the JAX kernel's fast correlation
// (pallas_scan.py:87-136, 291-294, 324-327) is one bf16 MXU pass; here it
// runs on the tensor cores. Per block the correlation is a product of two
// matrices, the Hankel matrix A[l', i] = x[dec*l' + i] (N/dec lags x 42 taps,
// zero taps to K = 48) by B (48 x 8 frequencies), as three products of the
// bf16 planes, m1 = cr br, m2 = ci bi, m3 = cd bs (cd = bf16(cr - ci) and
// bs = bf16(br + bi), each difference or sum taken in float32 first), with
// float32 accumulation; re = m1 + m2, im = m3 - m1 + m2. Each warp takes
// 16-lag tiles by mma.sync m16n8k16 (3 k-steps x 3 products per 16 x 8
// tile); a register of the A fragment is two consecutive samples, so the
// planes are staged in natural order (extended by their first 48 samples,
// so that the last lags read their wrapped samples) and read by one 32-bit
// load per register at even dec*l' (dec 2 and 4), two 16-bit loads at dec 1.
// The B fragments of the tile's 8 columns (18 registers) stay in registers
// for the whole block. The last 64/dec lags take D from a second product
// over the same fragments with the samples below N masked to zero, as the
// plain version's zero-padded boundary rows (ops/scan.py:73-80;
// pallas_scan.py:152-159). Shared memory: G of the tile beside the planes
// (31,392 bytes; the slice maxima take their place later), so the
// fragments never wait in registers for a barrier. The tile plan is the
// float32 kernel's (scan_tile: FT in {1, 2, 4}, at most dec, so that G holds
// at most N entries; the mma's columns beyond FT run on zero taps and are
// never written): 72,864 bytes at the widest tile, past the 48 KB a launch
// may take without opting in, so the launch raises the kernel's limit once
// per device and instance; three blocks per SM, at the register budget
// three allow (80 a thread). Tiles of 8 frequencies (114,336 bytes: two
// blocks per SM, 108 registers a thread) measured slower on the H100 at the
// main path's 64 windows, as did four blocks of tile 2 at 64 registers (with
// spills). What bounds it:
// the correlation's exact bf16 products are about 2 GFLOP at 64 windows,
// F = 101, dec 4, a few microseconds at the tensor peak, so the float32
// work after G (the ramp, the sync pairs, the pattern sums, |s| and the
// slice maxima, about two thirds of the kernel's time) and its
// shared-memory traffic bound it, the same work as the float32
// instantiation's, at three quarters of its warps per SM. Tolerance: the
// tensor core adds each k-step's 16 products in an order of its own, not
// the plain version's tap order, so G agrees with scan_plain(fast=True) to
// float32 rounding, not bit for bit: xb within 1e-4, positions equal but
// for near ties and the patterns that tie by construction
// (tools/run_hwtests.py check_scan).

#include "common.cuh"

namespace {

using namespace msk;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlice = 256;
constexpr int kSlices = 21;
constexpr int kMaxDepth = 8;
constexpr int kMainLen = 5120;  // dec * (the lags whose taps never wrap)
constexpr unsigned kFull = 0xffffffffu;

static_assert(kMainLen - 1 + kSyncTaps - 1 < kWindowLen, "a tap of the main lags wraps");
static_assert((kMainLen / 4) % kThreads == 0, "the threads share the main lags evenly");

// The float32 block's dynamic shared memory: the window (then G of the
// tile's frequencies), their taps, and the value and lag of each
// (frequency, pattern, slice) maximum. The widest tile (4, at dec 4) at
// depth 8 needs 48,192 bytes, within the 48 KB a launch may use without
// opting in, so four blocks fit on an SM.
constexpr int smem_bytes(int freq_tile, int depth) {
  return static_cast<int>(sizeof(float2)) *
         (kWindowLen + kSyncTaps * freq_tile + freq_tile * depth * kSlices);
}
static_assert(smem_bytes(4, kMaxDepth) <= 48 * 1024, "the widest block needs an opt-in");

// The kFast block: G of the tile's frequencies (at most N entries, as the
// float32 block's), then the bf16 planes cr, ci, cd of the window extended
// by its first kTapsPadded samples: 72,864 bytes at the widest tile, three
// blocks per SM.
constexpr int kTapsPadded = 48;  // K of the product: three k-steps of 16 taps
constexpr int kMmaCols = 8;      // frequencies of an mma tile
constexpr int kPlaneLen = kWindowLen + kTapsPadded;
constexpr int kPlanesBytes = 3 * kPlaneLen * 2;
constexpr int fast_smem_bytes(int freq_tile, int dec) {
  return freq_tile * (kWindowLen / dec) * static_cast<int>(sizeof(float2)) + kPlanesBytes;
}
static_assert(kPlanesBytes % 16 == 0, "the planes keep 16-byte alignment");
static_assert(4 * kMaxDepth * kSlices * 8 <= kPlanesBytes,
              "the slice maxima fit in the planes' place");
static_assert(3 * (fast_smem_bytes(4, 4) + 1024) <= 233472, "three blocks fit on an SM");

// ---- shared by both instantiations ------------------------------------------

// Block b: window b / tiles, frequencies f0 .. f0 + nf - 1 (the last tile of
// a window is ragged).
struct Tile {
  int w, f0, nf;
};

__device__ __forceinline__ Tile block_tile(int F, int freq_tile) {
  const int tiles = (F + freq_tile - 1) / freq_tile;
  const int w = blockIdx.x / tiles;
  const int f0 = (blockIdx.x - w * tiles) * freq_tile;
  return {w, f0, min(freq_tile, F - f0)};
}

// A lag whose taps wrap: R + chi_f * D, D the sum over the wrapped taps.
__device__ __forceinline__ float2 wrap_correct(float2 R, float2 chi_f, float2 D) {
  return cadd(R, cmul(chi_f, D));
}

// G[ft * N/dec + l] = E[f0 + ft, l] * r: the phase ramp.
template <int DEC>
__device__ __forceinline__ void store_g(float2* G, const float2* __restrict__ E_dec, int f0,
                                        int ft, int l, float2 r) {
  constexpr int n2 = kWindowLen / DEC;
  G[ft * n2 + l] = cmul(E_dec[static_cast<size_t>(f0 + ft) * n2 + l], r);
}

// |s_p| at coarse lag l for the patterns p < depth, in the plain version's
// order (patterns 6 and 7 need T_0, T_3, T_4, which depth > 6 computes).
// T_m(l) = H[l + 864m/dec], indices mod N/dec.
template <int DEC>
__device__ __forceinline__ void pattern_metrics(const float2* H, int l, int depth,
                                                float (&m)[kMaxDepth]) {
  constexpr int n2 = kWindowLen / DEC;
  float2 T[kFrames];
#pragma unroll
  for (int k = 0; k < kFrames; ++k) {
    if (k < depth) {
      int a = l + (kFrameLen * k) / DEC;
      a -= (a >= n2) ? n2 : 0;
      T[k] = H[a];
    }
  }
  float2 S = T[0];
  m[0] = hypotf(S.x, S.y);
#pragma unroll
  for (int p = 1; p < kFrames; ++p) {
    if (p < depth) {
      S = cadd(S, T[p]);
      m[p] = hypotf(S.x, S.y);
    }
  }
  if (depth > kFrames) {
    const float2 S6 = cadd(T[0], T[3]);
    m[6] = hypotf(S6.x, S6.y);
    if (depth > kFrames + 1) {
      const float2 S7 = cadd(S6, T[4]);
      m[7] = hypotf(S7.x, S7.y);
    }
  }
}

// G of the tile's nf frequencies becomes H[l] = G[l] + G[l + 336/dec] in
// place, RG frequencies at a time: each thread reads its share into
// registers before a barrier and writes it after one. Call it after the
// barrier that completes G.
template <int DEC, int RG>
__device__ __forceinline__ void sync_pairs(float2* G, int nf) {
  constexpr int n2 = kWindowLen / DEC;
  constexpr int kPer = (RG * n2 + kThreads - 1) / kThreads;
  for (int r0 = 0; r0 < nf; r0 += RG) {
    float2* Gr = G + r0 * n2;
    const int count = min(RG, nf - r0) * n2;
    float2 h[kPer];
#pragma unroll
    for (int v = 0; v < kPer; ++v) {
      const int e = threadIdx.x + v * kThreads;
      if (e < count) {
        const int row = e / n2;
        const int l = e - row * n2;
        int l2 = l + kSecondSync / DEC;
        l2 -= (l2 >= n2) ? n2 : 0;
        h[v] = cadd(Gr[row * n2 + l], Gr[row * n2 + l2]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int v = 0; v < kPer; ++v) {
      const int e = threadIdx.x + v * kThreads;
      if (e < count) Gr[e] = h[v];
    }
    __syncthreads();
  }
}

// Every pattern's (max, first argmax) per (frequency, slice) of H into
// smax / sarg [(ft * depth + p) * 21 + s]: kSliceLanes lanes per slice
// (4 or more lags each), kSlicesPerWarp slices per warp at a time.
template <int DEC>
__device__ __forceinline__ void slice_maxima(const float2* H, int nf, int depth, float* smax,
                                             int* sarg) {
  constexpr int n2 = kWindowLen / DEC;
  constexpr int slice2 = kSlice / DEC;
  constexpr int kSliceLanes = slice2 >= 128 ? 32 : 16;
  constexpr int kSlicesPerWarp = 32 / kSliceLanes;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sl = lane % kSliceLanes;
  for (int base = 0; base < nf * kSlices; base += kWarps * kSlicesPerWarp) {
    const int task = base + warp * kSlicesPerWarp + lane / kSliceLanes;
    const bool active = task < nf * kSlices;
    const int ft = task / kSlices;
    const int s = task - ft * kSlices;
    float best[kMaxDepth];
    int arg[kMaxDepth];
#pragma unroll
    for (int p = 0; p < kMaxDepth; ++p) {
      best[p] = -1.f;
      arg[p] = slice2;
    }
    if (active) {
      const float2* Hf = H + ft * n2;
      for (int j = sl; j < slice2; j += kSliceLanes) {  // j upward: the first maximum stays
        int l = s * slice2 + j;
        l -= (l >= n2) ? n2 : 0;
        float m[kMaxDepth];
        pattern_metrics<DEC>(Hf, l, depth, m);
#pragma unroll
        for (int p = 0; p < kMaxDepth; ++p) {
          if (p < depth && m[p] > best[p]) {
            best[p] = m[p];
            arg[p] = j;
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kMaxDepth; ++p) {
      if (p < depth) {
        float b = best[p];
        int a = arg[p];
        for (int o = kSliceLanes / 2; o > 0; o >>= 1) {  // within the slice's lanes
          const float ob = __shfl_xor_sync(kFull, b, o);
          const int oa = __shfl_xor_sync(kFull, a, o);
          if (ob > b || (ob == b && oa < a)) {
            b = ob;
            a = oa;
          }
        }
        if (active && sl == 0) {
          smax[(ft * depth + p) * kSlices + s] = b;
          sarg[(ft * depth + p) * kSlices + s] = a;
        }
      }
    }
  }
}

// The top-k slices per (f, p) by rank, value descending, slice index
// ascending: one warp per (f, p), a lane per slice counts the slices that
// beat it, and a lane whose rank is below k writes its slot.
template <int DEC>
__device__ __forceinline__ void top_k_rank(const float* smax, const int* sarg, const Tile& t,
                                           int F, int depth, int num_cand,
                                           int* __restrict__ pos_out, float* __restrict__ xb_out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int task = warp; task < t.nf * depth; task += kWarps) {
    if (lane >= kSlices) continue;
    const float* sm = smax + task * kSlices;
    const float v = sm[lane];
    int rank = 0;
    for (int s = 0; s < kSlices; ++s) {
      const float o = sm[s];
      rank += (o > v || (o == v && s < lane)) ? 1 : 0;
    }
    if (rank < num_cand) {
      const int ft = task / depth;
      const int p = task - ft * depth;
      const size_t out =
          (static_cast<size_t>(t.w * F + t.f0 + ft) * depth + p) * num_cand + rank;
      pos_out[out] = (kSlice * lane + DEC * sarg[task * kSlices + lane]) % kWindowLen;
      xb_out[out] = v;
    }
  }
}

// Everything after G: H in place (RG frequencies at a time), the slice
// maxima (whose buffers may overlap the staged window, read for the last
// time before the barrier that completed G) and the top-k.
template <int DEC, int RG>
__device__ __forceinline__ void select_candidates(float2* G, const Tile& t, int F, int depth,
                                                  int num_cand, float* smax, int* sarg,
                                                  int* __restrict__ pos_out,
                                                  float* __restrict__ xb_out) {
  sync_pairs<DEC, RG>(G, t.nf);
  slice_maxima<DEC>(G, t.nf, depth, smax, sarg);
  __syncthreads();
  top_k_rank<DEC>(smax, sarg, t, F, depth, num_cand, pos_out, xb_out);
}

// ---- float32 ----------------------------------------------------------------

template <int DEC, int FT>
__global__ void __launch_bounds__(kThreads, 4)
scan_kernel(const float2* __restrict__ c, const float2* __restrict__ B,
            const float2* __restrict__ E_dec, const float2* __restrict__ chi,
            int* __restrict__ pos_out, float* __restrict__ xb_out, int F, int depth,
            int num_cand) {
  constexpr int n2 = kWindowLen / DEC;
  constexpr int kMain = kMainLen / DEC;     // lags whose 42 taps never wrap
  constexpr int kLags = kMain / kThreads;   // of them per thread: 20/dec
  constexpr int kTail = n2 - kMain;         // the last 64/dec lags
  static_assert(FT <= DEC, "G of the tile's frequencies fits in the window's place");
  static_assert(kTail * FT <= kThreads, "one wrapping lag per thread");
  extern __shared__ float4 smem[];
  // the window, polyphase; once the correlation is done, G[ft * n2 + l]
  float2* cs = reinterpret_cast<float2*>(smem);
  float2* G = cs;
  float2* Bs = cs + kWindowLen;  // Bs[i * FT + ft]
  float* smax = reinterpret_cast<float*>(Bs + kSyncTaps * FT);  // [(ft * depth + p) * 21 + s]
  int* sarg = reinterpret_cast<int*>(smax + FT * depth * kSlices);

  const Tile t = block_tile(F, FT);
  const int tid = threadIdx.x;

  const float4* cw = reinterpret_cast<const float4*>(c + static_cast<size_t>(t.w) * kWindowLen);
  for (int v = tid; v < kWindowLen / 2; v += kThreads) {
    const float4 q = cw[v];
    const int s = 2 * v;
    cs[(s % DEC) * n2 + s / DEC] = make_float2(q.x, q.y);
    cs[((s + 1) % DEC) * n2 + (s + 1) / DEC] = make_float2(q.z, q.w);
  }
  for (int j = tid; j < kSyncTaps * FT; j += kThreads) {
    const int i = j / FT;
    const int ft = j - i * FT;
    Bs[j] = ft < t.nf ? B[i * F + t.f0 + ft] : make_float2(0.f, 0.f);
  }
  __syncthreads();

  // the correlation at the lags whose taps never wrap: lags tid + 256u of
  // every frequency of the tile, all in registers, taps in order 0..41
  float2 acc[kLags][FT];
#pragma unroll
  for (int u = 0; u < kLags; ++u)
#pragma unroll
    for (int ft = 0; ft < FT; ++ft) acc[u][ft] = make_float2(0.f, 0.f);
#pragma unroll 6
  for (int i = 0; i < kSyncTaps; ++i) {
    // sample dec*l + i of lag l sits at (i % dec) * n2 + l + i / dec
    const float2* ci = cs + (i % DEC) * n2 + i / DEC + tid;
    float2 b[FT];
#pragma unroll
    for (int ft = 0; ft < FT; ++ft) b[ft] = Bs[i * FT + ft];
#pragma unroll
    for (int u = 0; u < kLags; ++u) {
      const float2 a = ci[u * kThreads];
#pragma unroll
      for (int ft = 0; ft < FT; ++ft) acc[u][ft] = cadd(acc[u][ft], cmul_conj(a, b[ft]));
    }
  }
  // one of the last lags, whose wrapped taps also carry chi
  const int tail_ft = tid / kTail;
  const int tail_l = kMain + (tid - tail_ft * kTail);
  const bool has_tail = tail_ft < t.nf;
  float2 tail = make_float2(0.f, 0.f);
  if (has_tail) {
    float2 D = make_float2(0.f, 0.f);
    for (int i = 0; i < kSyncTaps; ++i) {
      int s = DEC * tail_l + i;
      const bool wrapped = s >= kWindowLen;
      s -= wrapped ? kWindowLen : 0;
      const float2 v = cmul_conj(cs[(s % DEC) * n2 + s / DEC], Bs[i * FT + tail_ft]);
      tail = cadd(tail, v);
      if (wrapped) D = cadd(D, v);
    }
    tail = wrap_correct(tail, chi[t.f0 + tail_ft], D);
  }
  __syncthreads();  // the window is read for the last time
#pragma unroll
  for (int u = 0; u < kLags; ++u)
#pragma unroll
    for (int ft = 0; ft < FT; ++ft)
      if (ft < t.nf) store_g<DEC>(G, E_dec, t.f0, ft, tid + u * kThreads, acc[u][ft]);
  if (has_tail) store_g<DEC>(G, E_dec, t.f0, tail_ft, tail_l, tail);
  __syncthreads();
  select_candidates<DEC, FT>(G, t, F, depth, num_cand, smax, sarg, pos_out, xb_out);
}

// ---- kFast: the correlation on the tensor cores --------------------------------

// Samples s and s + 1 of a bf16 plane as one operand register, s in the
// low half: one aligned 32-bit load where s is even (every s at dec 2 and
// 4), two 16-bit loads at dec 1.
template <int DEC>
__device__ __forceinline__ unsigned load_pair(const __nv_bfloat16* plane, int s) {
  if constexpr (DEC % 2 == 0) {
    return *reinterpret_cast<const unsigned*>(plane + s);
  } else {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(plane);
    return static_cast<unsigned>(h[s]) | (static_cast<unsigned>(h[s + 1]) << 16);
  }
}

template <int DEC, int FT>
__global__ void __launch_bounds__(kThreads, 3)
scan_fast_kernel(const float2* __restrict__ c, const float2* __restrict__ B,
                 const float2* __restrict__ E_dec, const float2* __restrict__ chi,
                 int* __restrict__ pos_out, float* __restrict__ xb_out, int F, int depth,
                 int num_cand) {
  constexpr int n2 = kWindowLen / DEC;
  constexpr int kTiles = n2 / 16;                  // 16-lag tiles of the product
  constexpr int kMainTiles = kMainLen / DEC / 16;  // those whose taps never wrap
  static_assert(n2 % 16 == 0 && (kMainLen / DEC) % 16 == 0, "whole 16-lag tiles");
  static_assert(FT <= DEC && FT <= kMmaCols, "G of the tile holds at most N entries");
  static_assert(DEC * (n2 - 1) + kTapsPadded <= kPlaneLen, "the last lags read the extension");
  extern __shared__ float4 smem[];
  float2* G = reinterpret_cast<float2*>(smem);  // G[ft * n2 + l]
  __nv_bfloat16* planes[3];                      // cr, ci, cd
  planes[0] = reinterpret_cast<__nv_bfloat16*>(G + FT * n2);
  planes[1] = planes[0] + kPlaneLen;
  planes[2] = planes[1] + kPlaneLen;
  // the slice maxima, in the planes' place once the correlation is done
  float* smax = reinterpret_cast<float*>(planes[0]);
  int* sarg = reinterpret_cast<int*>(smax + FT * depth * kSlices);

  const Tile t = block_tile(F, FT);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int q4 = lane & 3;

  // the planes in natural order, sample s at s mod N: two samples per
  // 16-byte load, each plane's pair one 32-bit store
  const float4* cw = reinterpret_cast<const float4*>(c + static_cast<size_t>(t.w) * kWindowLen);
  for (int v = tid; v < kPlaneLen / 2; v += kThreads) {
    const float4 q = cw[v < kWindowLen / 2 ? v : v - kWindowLen / 2];
    reinterpret_cast<unsigned*>(planes[0])[v] = pack_bf16(make_float2(q.x, q.z));
    reinterpret_cast<unsigned*>(planes[1])[v] = pack_bf16(make_float2(q.y, q.w));
    reinterpret_cast<unsigned*>(planes[2])[v] = pack_bf16(make_float2(q.x - q.y, q.z - q.w));
  }
  // the B fragments of column g (frequency f0 + g; zero beyond the tile and
  // at taps 42-47), rounded: br, bi and bs = br + bi, per k-step
  unsigned bf[3][3][2];  // [product][k-step][register]
#pragma unroll
  for (int kk = 0; kk < 3; ++kk) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = 16 * kk + 8 * r + 2 * q4;  // taps i and i + 1 (both below 42 or neither)
      float2 lo = make_float2(0.f, 0.f), hi = lo;
      if (g < t.nf && i < kSyncTaps) {
        lo = B[i * F + t.f0 + g];
        hi = B[(i + 1) * F + t.f0 + g];
      }
      bf[0][kk][r] = pack_bf16(make_float2(lo.x, hi.x));
      bf[1][kk][r] = pack_bf16(make_float2(lo.y, hi.y));
      bf[2][kk][r] = pack_bf16(make_float2(lo.x + lo.y, hi.x + hi.y));
    }
  }
  __syncthreads();

  // the three products of the tile of lags l0 .. l0 + 15 over the 48 taps;
  // wrapped_only: over the taps at samples >= N only (D), the rest masked
  auto products = [&](int l0, bool wrapped_only, float (&m)[3][4]) {
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int j = 0; j < 4; ++j) m[p][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 3; ++kk) {
      unsigned a[3][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        // register r: row g + 8 (r & 1), columns 16 kk + 2t + 8 (r >> 1), + 1
        const int s = DEC * (l0 + g + 8 * (r & 1)) + 16 * kk + 2 * q4 + 8 * (r >> 1);
        const unsigned keep = !wrapped_only ? kFull
                              : (s >= kWindowLen ? 0xffffu : 0u) |
                                    (s + 1 >= kWindowLen ? 0xffff0000u : 0u);
#pragma unroll
        for (int p = 0; p < 3; ++p) a[p][r] = load_pair<DEC>(planes[p], s) & keep;
      }
#pragma unroll
      for (int p = 0; p < 3; ++p) mma_bf16(m[p], a[p], bf[p][kk][0], bf[p][kk][1]);
    }
  };
  for (int mt = tid >> 5; mt < kTiles; mt += kWarps) {
    const int l0 = 16 * mt;
    float m[3][4];
    products(l0, false, m);
    float2 r[4];  // (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
#pragma unroll
    for (int j = 0; j < 4; ++j) r[j] = make_float2(m[0][j] + m[1][j], m[2][j] - m[0][j] + m[1][j]);
    if (mt >= kMainTiles) {  // the last 64/dec lags: their wrapped taps also carry chi
      products(l0, true, m);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ft = 2 * q4 + (j & 1);
        if (ft < t.nf)
          r[j] = wrap_correct(r[j], chi[t.f0 + ft],
                              make_float2(m[0][j] + m[1][j], m[2][j] - m[0][j] + m[1][j]));
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ft = 2 * q4 + (j & 1);
      if (ft < t.nf) store_g<DEC>(G, E_dec, t.f0, ft, l0 + g + 8 * (j >> 1), r[j]);
    }
  }
  __syncthreads();  // G is complete; the planes are read for the last time
  select_candidates<DEC, FT>(G, t, F, depth, num_cand, smax, sarg, pos_out, xb_out);
}

struct ScanArgs {
  const float2* c;
  const float2* B;
  const float2* E_dec;
  const float2* chi;
  int* pos_out;
  float* xb_out;
  int n_win, F, depth, num_cand;
  cudaStream_t stream;
};

// The kFast launch takes more than the 48 KB of dynamic shared memory a
// launch may use without opting in: it raises the kernel's limit once per
// device and template instance (opt_in_once).
template <int DEC, int FT>
cudaError_t opt_in_fast() {
  static std::atomic<unsigned long long> done{0};
  return opt_in_once(done, [] {
    cudaError_t err = cudaFuncSetAttribute(scan_fast_kernel<DEC, FT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           fast_smem_bytes(FT, DEC));
    if (err == cudaSuccess)  // the SM's largest carve-out: three blocks of the widest tile
      err = cudaFuncSetAttribute(scan_fast_kernel<DEC, FT>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    return err;
  });
}

template <int DEC, int FT, bool kFast>
cudaError_t launch(const ScanArgs& a) {
  const int blocks = a.n_win * ((a.F + FT - 1) / FT);
  if constexpr (kFast) {
    const cudaError_t err = opt_in_fast<DEC, FT>();
    if (err != cudaSuccess) return err;
    scan_fast_kernel<DEC, FT><<<blocks, kThreads, fast_smem_bytes(FT, DEC), a.stream>>>(
        a.c, a.B, a.E_dec, a.chi, a.pos_out, a.xb_out, a.F, a.depth, a.num_cand);
  } else {
    scan_kernel<DEC, FT><<<blocks, kThreads, smem_bytes(FT, a.depth), a.stream>>>(
        a.c, a.B, a.E_dec, a.chi, a.pos_out, a.xb_out, a.F, a.depth, a.num_cand);
  }
  return cudaGetLastError();
}

template <int DEC, bool kFast>
cudaError_t launch_tile(const ScanArgs& a, int freq_tile) {
  if (freq_tile == 1) return launch<DEC, 1, kFast>(a);
  if constexpr (DEC >= 2) {
    if (freq_tile == 2) return launch<DEC, 2, kFast>(a);
  }
  if constexpr (DEC >= 4) {
    if (freq_tile == 4) return launch<DEC, 4, kFast>(a);
  }
  return cudaErrorInvalidValue;  // a tile wider than dec does not fit
}

template <int DEC>
cudaError_t launch_mode(const ScanArgs& a, int freq_tile, bool fast) {
  return fast ? launch_tile<DEC, true>(a, freq_tile) : launch_tile<DEC, false>(a, freq_tile);
}

}  // namespace

// Plain C interface (ctypes). Launches on `stream`; returns
// cudaGetLastError() after the launch. freq_tile: frequencies per block
// (1, 2 or 4, at most dec; the wrapper's scan_tile); fast != 0: the kFast
// instantiation. c must be 16-byte aligned.
extern "C" int msk_scan(const void* c, const void* B, const void* E_dec, const void* chi,
                        void* pos_out, void* xb_out, int n_win, int F, int depth,
                        int num_cand, int dec, int freq_tile, int fast, void* stream) {
  if (n_win <= 0 || F <= 0) return 0;
  if (depth < 1 || depth > kMaxDepth || num_cand < 1 || num_cand > 8 ||
      reinterpret_cast<uintptr_t>(c) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const ScanArgs a{static_cast<const float2*>(c), static_cast<const float2*>(B),
                   static_cast<const float2*>(E_dec), static_cast<const float2*>(chi),
                   static_cast<int*>(pos_out), static_cast<float*>(xb_out), n_win, F, depth,
                   num_cand, static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (dec) {
    case 1: err = launch_mode<1>(a, freq_tile, fast != 0); break;
    case 2: err = launch_mode<2>(a, freq_tile, fast != 0); break;
    case 4: err = launch_mode<4>(a, freq_tile, fast != 0); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The message of a CUDA error code, for the Python wrappers' exceptions.
extern "C" const char* msk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
