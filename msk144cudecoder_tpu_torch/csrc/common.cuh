// Shared device helpers of the decoder's CUDA kernels (scan.cu,
// survivor.cu, demod.cu, bp.cu). Complex values are float2 (x = real,
// y = imag), the layout of torch.complex64.
#pragma once

#include <atomic>
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

// b's two forms for cmul_bf16: (b.x, b.x) and (b.y, -b.y)
__device__ __forceinline__ uint2 bf16_forms(unsigned b) {
  return make_uint2(__byte_perm(b, 0, 0x1010), __byte_perm(b, 0, 0x3232) ^ 0x80000000u);
}

// a * b in bf16 from b's forms: (a.x b.x, a.y b.x) plus, swapped, (a.x b.y,
// -a.y b.y), that is (a.x b.x - a.y b.y, a.y b.x + a.x b.y) with each product
// and sum rounded once: precision.cmul_bf16's bits (x - y is x + (-y), and
// neither a product nor a sum of two depends on the order of its operands).
__device__ __forceinline__ unsigned cmul_bf16(unsigned a, uint2 bf) {
  return add_bf16x2(mul_bf16x2(a, bf.x), __byte_perm(mul_bf16x2(a, bf.y), 0, 0x1032));
}

// The 12 matched-filter taps into registers (warp_tail).
__device__ __forceinline__ void load_taps(const float* __restrict__ pp12, float (&pp)[12]) {
#pragma unroll
  for (int i = 0; i < 12; ++i) pp[i] = pp12[i];
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr int kSoftbits = 144;     // channel softbits of a frame
constexpr int kSoftbitSlots = 5;   // softbits per lane in warp_tail: t = lane + 32j, j < 5

// The float32 matched-filter tail of kernels B2 and B4 (ops/pallas_demod.py::mf_tail
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
// and the count to *nbad_out. kFast: mma_tail (below).
__device__ __forceinline__ void warp_tail(const float2* fr, const float2* __restrict__ sync_conj,
                                          const float (&pp)[12],
                                          const int* __restrict__ sync_pm, float* stage,
                                          float* __restrict__ sb_out, int* __restrict__ nbad_out) {
  const int lane = threadIdx.x & 31;

  float2 s1 = make_float2(0.f, 0.f);
  float2 s2 = make_float2(0.f, 0.f);
  for (int i = lane; i < kSyncTaps; i += 32) {
    const float2 sc = sync_conj[i];
    s1 = cadd(s1, cmul(fr[i], sc));
    s2 = cadd(s2, cmul(fr[kSecondSync + i], sc));
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
  auto tap = [&](int j, int i, float2 z) { v[j] += (z.x * ca + z.y * cb) * pp[i]; };
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

// ---- kFast: the matched-filter tail on the tensor cores (kernels B2, B4) ----
//
// The 144 softbits' 12-tap sums as one bf16 matrix product. Softbit t reads
// frame samples (6(t - 1) + i) mod 864, i < 12: with f = sample + 6 (f < 6:
// samples 858-863 again), t = 4j + m reads f = 24j + 6m + i. So row j < 36
// of A is the 32 words f = 24j ... 24j + 31 (30 samples and two zero pads),
// each sample one (x, y) pair of K = 64, and column 2m + e of B (64 by 8) is
// the taps pp at rows 2(6m + i) + e: A B holds (sum z.x pp, sum z.y pp) of
// the four softbits of row j. Three 16-row tiles, four k-steps of
// m16n8k16 each (the last half tile, rows 40-47, unused).

// The frame in shared memory, packed bf16 pairs (pack_bf16's layout), word
// f at frame_word(f): four words of padding after every 24, so that rows
// 24 samples apart sit 28 words apart and a fragment load's eight rows and
// four columns meet 32 banks. f < 872: 6 + 864 + the two zero pads.
constexpr int kFrameLead = 6;
constexpr int kRowSamples = 24;
constexpr int kRowPad = 4;
constexpr int kTailRows = 36;
constexpr int kFrameWords = 872;
constexpr int kPackedFrameWords = kFrameWords + kRowPad * (kFrameWords / kRowSamples);  // 1016
constexpr int kTailBWords = 8 * 32;  // B's fragments: 8 words a lane

__host__ __device__ constexpr int frame_word(int f) { return f + kRowPad * (f / kRowSamples); }

// D += A B by mma.sync m16n8k16, bf16 operands, float32 accumulation. With
// g = lane / 4 and t = lane % 4: a holds A's rows g, g + 8 at columns
// (2t, 2t + 1) and then (2t + 8, 2t + 9), each register a pair, the lower
// column in the low half; b0, b1 hold B's rows (2t, 2t + 1) and (2t + 8,
// 2t + 9) of column g; d holds (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8,
// 2t + 1). Kernels B1 (scan.cu), B2 and B4 (mma_tail) in kFast.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B's fragments into tail_b (kTailBWords, shared by a block's warps): word
// 32 (2 kk + i) + lane is lane (g, c)'s register i of k-step kk, column g
// (softbit 4j + g / 2, part g % 2) at sample o = 8 kk + 4 i + c of the row:
// (pp[o - 6m], 0) or (0, pp[o - 6m]), the taps rounded to bf16, zero where
// o - 6m is no tap. Ends in no barrier.
__device__ __forceinline__ void store_tail_b(const float* __restrict__ pp12, unsigned* tail_b) {
  for (int w = threadIdx.x; w < kTailBWords; w += blockDim.x) {
    const int lane = w & 31, g = lane >> 2;
    const int tap = 4 * (w >> 5) + (lane & 3) - 6 * (g >> 1);
    const float p = tap >= 0 && tap < 12 ? pp12[tap] : 0.f;
    tail_b[w] = pack_bf16(g & 1 ? make_float2(0.f, p) : make_float2(p, 0.f));
  }
}

// A lane's constants of mma_tail: its sync taps conj(cb42)[lane] and [32 +
// lane] (packed bf16, zero past 42) and the sync word's signs (bit k set
// where sync_pm[k] < 0).
struct MmaTaps {
  unsigned sc[2];
  unsigned neg_pm;
};

__device__ __forceinline__ MmaTaps load_mma_taps(const float2* __restrict__ sync_conj,
                                                 const int* __restrict__ sync_pm) {
  const int lane = threadIdx.x & 31;
  MmaTaps t;
  t.sc[0] = pack_bf16(sync_conj[lane]);
  t.sc[1] = lane + 32 < kSyncTaps ? pack_bf16(sync_conj[lane + 32]) : 0u;
  t.neg_pm = 0u;
#pragma unroll
  for (int k = 0; k < 8; ++k) t.neg_pm |= static_cast<unsigned>(sync_pm[k] < 0) << k;
  return t;
}

// Where mma_tail reads its frame: a functor with sample(l), the packed
// frame sample l < 864, and word(mt, h, s), lane (g, c)'s word of A at row
// 16 mt + 8 h + g (tile 2: row min(32 + g, 35), h = 0 only) and sample
// 4 s + c of the row (s < 8). Two layouts: PackedFrame (kernel B2) and
// LagFrame (kernel B4).
//
// PackedFrame: one packed frame (kPackedFrameWords, frame_word's layout,
// its zero pads written).
struct PackedFrame {
  const unsigned* fr;
  const unsigned* row_g;     // row g at column c
  const unsigned* row_last;  // row min(32 + g, 35) at column c

  __device__ __forceinline__ explicit PackedFrame(const unsigned* frame) : fr(frame) {
    constexpr int kRowWords = kRowSamples + kRowPad;
    const int lane = threadIdx.x & 31;
    row_g = fr + kRowWords * (lane >> 2) + (lane & 3);
    row_last = fr + kRowWords * min(32 + (lane >> 2), kTailRows - 1) + (lane & 3);
  }
  __device__ __forceinline__ unsigned sample(int l) const {
    return fr[frame_word(l + kFrameLead)];
  }
  // samples 24-31 of a row after the row's pad
  __device__ __forceinline__ unsigned word(int mt, int h, int s) const {
    const int o = 4 * s + (s >= 6 ? kRowPad : 0);
    return mt == 2 ? row_last[o] : row_g[(kRowSamples + kRowPad) * (16 * mt + 8 * h) + o];
  }
};

// LagFrame: the frame at lag ps of a packed pattern sum za (kernel B4):
// frame sample l is word ps + l (the pattern's samples 0-864 again after N,
// so that no frame wraps; a frame reads up to ps + 865, a zero tap). Row
// j's sample x is frame sample 24 j + x - 6, but for x < 6 of row 0 (lanes
// g = 0, s < 2) the frame's own samples 858-863.
struct LagFrame {
  const unsigned* za;
  int ps;
  int base;     // row 0's word at column c as if it had no lead
  int row0[2];  // row g's words at s = 0, 1 (lanes g = 0: the lead where x < 6)

  __device__ __forceinline__ LagFrame(const unsigned* pattern_sum, int lag)
      : za(pattern_sum), ps(lag) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, c = lane & 3;
    base = ps - kFrameLead + c;
#pragma unroll
    for (int s = 0; s < 2; ++s)
      row0[s] = g == 0 && 4 * s + c < kFrameLead ? ps + kFrameLen - kFrameLead + 4 * s + c
                                                 : base + kRowSamples * g + 4 * s;
  }
  __device__ __forceinline__ unsigned sample(int l) const { return za[ps + l]; }
  __device__ __forceinline__ unsigned word(int mt, int h, int s) const {
    if (mt == 0 && h == 0 && s < 2) return za[row0[s]];
    const int g = (threadIdx.x & 31) >> 2;
    const int row = mt == 2 ? min(32 + g, kTailRows - 1) : 16 * mt + 8 * h + g;
    return za[base + kRowSamples * row + 4 * s];
  }
};

// The matched-filter tail of kernels B2 and B4 in kFast, for one frame fr
// (PackedFrame or LagFrame) on one warp: all 32 lanes call it, and it
// passes no block barrier. The function of warp_tail with its operands
// rounded to bf16, in another order of sums and with the derotation after
// the taps (ops/precision.py, last paragraph). Carrier phase: s =
// sum_i z[i] conj(cb42[i]) + z[336 + i] conj(cb42[i]), i < 42, a lane's
// taps, then the warp's; cfac = conj(s) / |s| = (cre, cim). Softbits: A B
// on the tensor cores (above), twelve mma.sync; lane (g, c) receives (X, Y)
// of softbit 4j + c for its rows j, which is t = lane + 32s, s < 5 (lanes
// 0-15 five, the rest four: warp_tail's layout), and derotates it in
// float32: Q rail (t even) cim X + cre Y, I rail cre X - cim Y. Mean and
// variance of the 144 in any order, nbadsync by ballot as warp_tail, and
// the scaled data softbits [8:56) + [64:144) out through `stage` (144
// floats, 16-byte aligned, the warp's own) as one coalesced 512-byte row.
template <class Frame>
__device__ __forceinline__ void mma_tail(const Frame& fr, const unsigned* tail_b,
                                         const MmaTaps& tp, float* stage,
                                         float* __restrict__ sb_out,
                                         int* __restrict__ nbad_out) {
  const int lane = threadIdx.x & 31;

  auto sample = [&](int l) { return unpack_bf16(fr.sample(l)); };
  const float2 sc0 = unpack_bf16(tp.sc[0]), sc1 = unpack_bf16(tp.sc[1]);
  float2 s = cadd(cmul(sample(lane), sc0), cmul(sample(kSecondSync + lane), sc0));
  if (lane + 32 < kSyncTaps) {
    s = cadd(s, cmul(sample(lane + 32), sc1));
    s = cadd(s, cmul(sample(kSecondSync + lane + 32), sc1));
  }
  s.x = warp_sum(s.x);
  s.y = warp_sum(s.y);
  const float inv = 1.f / fmaxf(sqrtf(s.x * s.x + s.y * s.y), 1e-30f);
  const float cre = s.x * inv;
  const float cim = -s.y * inv;

  // tile mt: rows 16 mt + g and + 8, the last tile's rows 32 + g (past row
  // 35 a copy of row 35, never used) and zeros for rows 40-47; k-step kk:
  // samples 8 kk .. 8 kk + 7 of a row (s = 2 kk, 2 kk + 1)
  auto a = [&](int mt, int h, int s) { return mt == 2 && h ? 0u : fr.word(mt, h, s); };
  float d[3][4] = {};
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const unsigned b0 = tail_b[32 * (2 * kk) + lane], b1 = tail_b[32 * (2 * kk + 1) + lane];
#pragma unroll
    for (int mt = 0; mt < 3; ++mt) {
      const int s = 2 * kk;
      const unsigned frag[4] = {a(mt, 0, s), a(mt, 1, s), a(mt, 0, s + 1), a(mt, 1, s + 1)};
      mma_bf16(d[mt], frag, b0, b1);
    }
  }
  // slot s = 2 mt + h: softbit t = lane + 32 s
  const float X[kSoftbitSlots] = {d[0][0], d[0][2], d[1][0], d[1][2], d[2][0]};
  const float Y[kSoftbitSlots] = {d[0][1], d[0][3], d[1][1], d[1][3], d[2][1]};

  // a lane's softbits are all on one rail (t and lane have one parity)
  const bool q_rail = (lane & 1) == 0;
  const float ca = q_rail ? cim : cre;
  const float cb = q_rail ? cre : -cim;
  const int slots = lane + 32 * (kSoftbitSlots - 1) < kSoftbits ? 5 : 4;  // lanes 0-15: 5
  float v[kSoftbitSlots];
  float sum = 0.f, sum2 = 0.f;
#pragma unroll
  for (int j = 0; j < kSoftbitSlots; ++j) {
    v[j] = j < slots ? ca * X[j] + cb * Y[j] : 0.f;
    sum += v[j];
    sum2 += v[j] * v[j];
  }
  sum = warp_sum(sum);
  sum2 = warp_sum(sum2);
  const float sav = sum / static_cast<float>(kSoftbits);
  const float s2av = sum2 / static_cast<float>(kSoftbits);
  const float ssig = sqrtf(fmaxf(s2av - sav * sav, 1e-30f));
  const float scale = 2.f / (ssig * 0.36f);

  const bool neg_pm = tp.neg_pm >> (lane & 7) & 1u;
  const bool bad = (lane < 8 && (v[0] < 0.f) != neg_pm) || (lane >= 24 && (v[1] < 0.f) != neg_pm);
  const int nbad = __popc(__ballot_sync(0xffffffffu, bad));

#pragma unroll
  for (int j = 0; j < kSoftbitSlots; ++j)
    if (j < slots) stage[lane + 32 * j] = v[j];
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

// A kernel's launch attributes (a shared-memory opt-in, a carve-out), set
// once per device: `set` calls cudaFuncSetAttribute the first time a device
// launches the kernel and never again, so that no later launch, and none
// captured into a CUDA graph, sets them. `done` is the kernel's own (a bit
// per device). An error is returned as the launch's, not left behind for
// the next launch's check, and `set` runs again at the next launch.
template <class Set>
inline cudaError_t opt_in_once(std::atomic<unsigned long long>& done, Set set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  const unsigned long long bit = 1ull << (dev & 63);
  if (err != cudaSuccess || (done.load() & bit) != 0) return err;
  err = set();
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  done.fetch_or(bit);
  return cudaSuccess;
}

}  // namespace msk
