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
// What bounds it on the H100: FP32 work, not device memory. Per (window, f)
// the correlation is 42 complex multiply-adds at each of N/dec lags (about
// 0.44 MFLOP at dec 4, with the pattern sums and magnitudes about 0.5), so a
// batch of 64 windows at F = 101 is 3.2 GFLOP, 0.048 ms at 67 TFLOP/s, while
// it reads 2.7 MB. The design:
//   - one block per (window, tile of FT frequencies), FT in {1, 2, 4} and
//     at most dec, chosen by the wrapper so that the grid still fills the
//     SMs; the window is staged once per block into shared memory with
//     16-byte loads, in polyphase order (sample s at (s mod dec) * N/dec +
//     s / dec), so that the lanes of a warp read consecutive words at every
//     tap;
//   - each thread holds all its 20/dec lags x FT frequencies of complex
//     sums in registers (20 at most): every sample read from shared memory
//     feeds FT products and every tap (a broadcast) 20/dec. The taps run in
//     order 0..41 for every output, and the lags whose taps wrap (one per
//     thread of the first FT * 64/dec) take the R + chi * D form, so G is
//     the per-lag loop's up to the sign of an exact zero;
//   - G of the tile's frequencies (FT * N/dec <= N entries) then takes the
//     window's place, so a block needs about 48 KB of dynamic shared memory
//     and four blocks (32 warps) fit on an SM;
//   - G is replaced in place by H[l] = G[l] + G[l + 336/dec], the frame's two
//     sync words, so that T_m(l) = G[l + 864m/dec] + G[l + (864m+336)/dec]
//     = H[l + 864m/dec] is one load with the same rounding; the pattern
//     stage builds T_m once per lag and every pattern from it, then reduces
//     each pattern's (max, first argmax) per slice with shuffles among the
//     slice's 16 or 32 lanes (each lane 4 or more lags);
//   - the top-k of the 21 slice maxima is a rank: one warp per (f, p), a
//     lane per slice counts the slices that beat it, and a lane whose rank
//     is below k writes its slot. Six block barriers in all, none per
//     pattern.
// No tensor cores in either instantiation.
//
// kFast (DecoderConfig.fast_math; ops/precision.py, B1) is the JAX kernel's
// fast correlation, pallas_scan.py:87-136, 291-294, 324-327: the window is
// staged as bf16 planes (cr, ci) and cd = cr - ci (6 bytes a sample in the
// window's place), the tile's taps as float4 (br, bi, br + bi) rounded to
// bf16, and each lag sums three products m1 = cr br, m2 = ci bi, m3 = cd bs
// in FP32 (each product of two bf16 values is exact, so a fused multiply-add
// rounds only the sum); G's sum is then (m1 + m2, m3 - m1 + m2), the wrap
// correction D the same over the wrapped taps. Three sums a lag in place of
// two raise the registers, so the fast blocks run three to an SM (a few
// spills at the widest tile); measured slower on the H100 at the main
// path's 64 windows: two blocks per SM without spills, and tiles of two
// frequencies. Everything after G is the FP32 instantiation's code.

#include "common.cuh"

namespace {

using namespace msk;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlice = 256;
constexpr int kSlices = 21;
constexpr int kMaxDepth = 8;
constexpr int kMainLen = 5120;  // dec * (the lags held in registers): no tap wraps there
constexpr unsigned kFull = 0xffffffffu;

static_assert(kMainLen - 1 + kSyncTaps - 1 < kWindowLen, "a tap of the tiled lags wraps");
static_assert((kMainLen / 4) % kThreads == 0, "the threads share the main lags evenly");

// A block's dynamic shared memory: the window (then G of the tile's
// frequencies), their taps, and the value and lag of each (frequency,
// pattern, slice) maximum. The widest tile (4, at dec 4) at depth 8 needs
// 48,192 bytes, within the 48 KB a launch may use without opting in, so
// four blocks fit on an SM.
constexpr int smem_bytes(int freq_tile, int depth) {
  return static_cast<int>(sizeof(float2)) *
         (kWindowLen + kSyncTaps * freq_tile + freq_tile * depth * kSlices);
}
static_assert(smem_bytes(4, kMaxDepth) <= 48 * 1024, "the widest block needs an opt-in");

// |s_p| at coarse lag l for the patterns p < depth, in the plain version's
// order (patterns 6 and 7 need T_0, T_3, T_4, which depth > 6 computes).
// H[l] = G[l] + G[l + 336/dec], so T_m(l) = G[l + 864m/dec] +
// G[l + (864m + 336)/dec] = H[l + 864m/dec], indices mod N/dec.
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

// kFast: the window's bf16 planes (cr, ci) and cd in the window's place, and
// the tile's taps (br, bi, bs) after them: 6 bytes a sample plus 16 a tap
// and frequency, within the 8 bytes a sample G of the tile takes later.
constexpr int kFastPlaneBytes = kWindowLen * 6;
static_assert(kFastPlaneBytes % 16 == 0, "the taps after the planes are 16-byte aligned");
static_assert(kFastPlaneBytes + kSyncTaps * 4 * 16 <= kWindowLen * 8,
              "the fast staging fits in the window's place");

template <int DEC, int FT, bool kFast>
__global__ void __launch_bounds__(kThreads, kFast ? 3 : 4)
scan_kernel(const float2* __restrict__ c, const float2* __restrict__ B,
            const float2* __restrict__ E_dec, const float2* __restrict__ chi,
            int* __restrict__ pos_out, float* __restrict__ xb_out, int F, int depth,
            int num_cand) {
  constexpr int n2 = kWindowLen / DEC;
  constexpr int kMain = kMainLen / DEC;     // lags whose 42 taps never wrap
  constexpr int kLags = kMain / kThreads;   // of them per thread: 20/dec
  constexpr int kTail = n2 - kMain;         // the last 64/dec lags
  constexpr int slice2 = kSlice / DEC;
  // lanes per slice in the pattern stage: 4 or more lags each
  constexpr int kSliceLanes = slice2 >= 128 ? 32 : 16;
  constexpr int kSlicesPerWarp = 32 / kSliceLanes;
  static_assert(FT <= DEC, "G of the tile's frequencies fits in the window's place");
  static_assert(kTail * FT <= kThreads, "one wrapping lag per thread");
  extern __shared__ float4 smem[];
  // the window, polyphase; once the correlation is done, G[ft * n2 + l]
  float2* cs = reinterpret_cast<float2*>(smem);
  float2* G = cs;
  float2* Bs = cs + kWindowLen;  // Bs[i * FT + ft]
  float* smax = reinterpret_cast<float*>(Bs + kSyncTaps * FT);  // [(ft * depth + p) * 21 + s]
  int* sarg = reinterpret_cast<int*>(smax + FT * depth * kSlices);

  const int tiles = (F + FT - 1) / FT;
  const int w = blockIdx.x / tiles;
  const int f0 = (blockIdx.x - w * tiles) * FT;
  const int nf = min(FT, F - f0);  // the last tile of a window is ragged
  const int tid = threadIdx.x;

  // kFast's staging (see kFastPlaneBytes): sample s of the polyphase
  // order at cri[s] = (cr, ci) and cdp[s] = cd; tap (i, ft) at Bf[i * FT + ft]
  __nv_bfloat162* cri = reinterpret_cast<__nv_bfloat162*>(smem);
  __nv_bfloat16* cdp = reinterpret_cast<__nv_bfloat16*>(cri + kWindowLen);
  float4* Bf = reinterpret_cast<float4*>(reinterpret_cast<char*>(smem) + kFastPlaneBytes);

  const float4* cw = reinterpret_cast<const float4*>(c + static_cast<size_t>(w) * kWindowLen);
  for (int v = tid; v < kWindowLen / 2; v += kThreads) {
    const float4 q = cw[v];
    const int s = 2 * v;
    const int s0 = (s % DEC) * n2 + s / DEC;
    const int s1 = ((s + 1) % DEC) * n2 + (s + 1) / DEC;
    if constexpr (kFast) {
      cri[s0] = __floats2bfloat162_rn(q.x, q.y);
      cdp[s0] = __float2bfloat16_rn(q.x - q.y);
      cri[s1] = __floats2bfloat162_rn(q.z, q.w);
      cdp[s1] = __float2bfloat16_rn(q.z - q.w);
    } else {
      cs[s0] = make_float2(q.x, q.y);
      cs[s1] = make_float2(q.z, q.w);
    }
  }
  for (int j = tid; j < kSyncTaps * FT; j += kThreads) {
    const int i = j / FT;
    const int ft = j - i * FT;
    const float2 b = ft < nf ? B[i * F + f0 + ft] : make_float2(0.f, 0.f);
    if constexpr (kFast)
      Bf[j] = make_float4(round_bf16(b.x), round_bf16(b.y), round_bf16(b.x + b.y), 0.f);
    else
      Bs[j] = b;
  }
  __syncthreads();

  // the correlation at the lags whose taps never wrap: lags tid + 256u of
  // every frequency of the tile, all in registers, taps in order 0..41
  float2 acc[kLags][FT];
  if constexpr (kFast) {
    float m1[kLags][FT], m2[kLags][FT], m3[kLags][FT];
#pragma unroll
    for (int u = 0; u < kLags; ++u)
#pragma unroll
      for (int ft = 0; ft < FT; ++ft) m1[u][ft] = m2[u][ft] = m3[u][ft] = 0.f;
#pragma unroll 6
    for (int i = 0; i < kSyncTaps; ++i) {
      const int off = (i % DEC) * n2 + i / DEC + tid;
      float4 b[FT];
#pragma unroll
      for (int ft = 0; ft < FT; ++ft) b[ft] = Bf[i * FT + ft];
#pragma unroll
      for (int u = 0; u < kLags; ++u) {
        const float2 a = __bfloat1622float2(cri[off + u * kThreads]);
        const float d = __bfloat162float(cdp[off + u * kThreads]);
#pragma unroll
        for (int ft = 0; ft < FT; ++ft) {
          m1[u][ft] += a.x * b[ft].x;
          m2[u][ft] += a.y * b[ft].y;
          m3[u][ft] += d * b[ft].z;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kLags; ++u)
#pragma unroll
      for (int ft = 0; ft < FT; ++ft)
        acc[u][ft] = make_float2(m1[u][ft] + m2[u][ft], m3[u][ft] - m1[u][ft] + m2[u][ft]);
  } else {
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
  }
  // one of the last lags, whose wrapped taps also carry chi
  const int tail_ft = tid / kTail;
  const int tail_l = kMain + (tid - tail_ft * kTail);
  const bool has_tail = tail_ft < nf;
  float2 tail = make_float2(0.f, 0.f);
  if (has_tail) {
    float2 D = make_float2(0.f, 0.f);
    if constexpr (kFast) {
      float r1 = 0.f, r2 = 0.f, r3 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
      for (int i = 0; i < kSyncTaps; ++i) {
        int s = DEC * tail_l + i;
        const bool wrapped = s >= kWindowLen;
        s -= wrapped ? kWindowLen : 0;
        const int at = (s % DEC) * n2 + s / DEC;
        const float2 a = __bfloat1622float2(cri[at]);
        const float4 b = Bf[i * FT + tail_ft];
        const float p1 = a.x * b.x, p2 = a.y * b.y, p3 = __bfloat162float(cdp[at]) * b.z;
        r1 += p1;
        r2 += p2;
        r3 += p3;
        if (wrapped) {
          d1 += p1;
          d2 += p2;
          d3 += p3;
        }
      }
      tail = make_float2(r1 + r2, r3 - r1 + r2);
      D = make_float2(d1 + d2, d3 - d1 + d2);
    } else {
      for (int i = 0; i < kSyncTaps; ++i) {
        int s = DEC * tail_l + i;
        const bool wrapped = s >= kWindowLen;
        s -= wrapped ? kWindowLen : 0;
        const float2 v = cmul_conj(cs[(s % DEC) * n2 + s / DEC], Bs[i * FT + tail_ft]);
        tail = cadd(tail, v);
        if (wrapped) D = cadd(D, v);
      }
    }
    tail = cadd(tail, cmul(chi[f0 + tail_ft], D));
  }
  __syncthreads();  // the window is read for the last time
#pragma unroll
  for (int u = 0; u < kLags; ++u) {
    const int l = tid + u * kThreads;
#pragma unroll
    for (int ft = 0; ft < FT; ++ft)
      if (ft < nf) G[ft * n2 + l] = cmul(E_dec[static_cast<size_t>(f0 + ft) * n2 + l], acc[u][ft]);
  }
  if (has_tail)
    G[tail_ft * n2 + tail_l] = cmul(E_dec[static_cast<size_t>(f0 + tail_ft) * n2 + tail_l], tail);
  __syncthreads();
  // G becomes H[l] = G[l] + G[l + 336/dec], the sum over the frame's two
  // sync words, so that T_m(l) = H[l + 864m/dec] with the same rounding
  auto sync_pair = [&](int ft, int l) {
    int l2 = l + kSecondSync / DEC;
    l2 -= (l2 >= n2) ? n2 : 0;
    return cadd(G[ft * n2 + l], G[ft * n2 + l2]);
  };
#pragma unroll
  for (int u = 0; u < kLags; ++u)
#pragma unroll
    for (int ft = 0; ft < FT; ++ft)
      if (ft < nf) acc[u][ft] = sync_pair(ft, tid + u * kThreads);
  if (has_tail) tail = sync_pair(tail_ft, tail_l);
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kLags; ++u)
#pragma unroll
    for (int ft = 0; ft < FT; ++ft)
      if (ft < nf) G[ft * n2 + tid + u * kThreads] = acc[u][ft];
  if (has_tail) G[tail_ft * n2 + tail_l] = tail;
  __syncthreads();

  // every pattern's (max, first argmax) per (frequency, slice): kSliceLanes
  // lanes per slice, kSlicesPerWarp slices per warp at a time
  const int warp = tid >> 5;
  const int lane = tid & 31;
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
      const float2* Hf = G + ft * n2;
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
  __syncthreads();

  // top-k slices per (f, p) by rank: value descending, slice index ascending
  for (int task = warp; task < nf * depth; task += kWarps) {
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
          (static_cast<size_t>(w * F + f0 + ft) * depth + p) * num_cand + rank;
      pos_out[out] = (kSlice * lane + DEC * sarg[task * kSlices + lane]) % kWindowLen;
      xb_out[out] = v;
    }
  }
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

template <int DEC, int FT, bool kFast>
cudaError_t launch(const ScanArgs& a) {
  const int blocks = a.n_win * ((a.F + FT - 1) / FT);
  scan_kernel<DEC, FT, kFast><<<blocks, kThreads, smem_bytes(FT, a.depth), a.stream>>>(
      a.c, a.B, a.E_dec, a.chi, a.pos_out, a.xb_out, a.F, a.depth, a.num_cand);
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
// cudaGetLastError() after the launch. freq_tile: frequencies
// per block (1, 2 or 4, at most dec; the wrapper's scan_tile); fast != 0:
// the kFast instantiation. c must be 16-byte aligned.
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
