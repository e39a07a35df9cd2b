// Kernel B3: LDPC(128,90) belief propagation with the CRC-13 gate.
//
// Replaces msk144cudecoder_tpu/ops/pallas_ldpc.py::_bp_kernel (launched by
// bp_decode_pallas). Every output (found, codeword, iterations, hard
// errors) is identical to the plain torch version in ops/ldpc.py
// (bp_decode_plain): the same order of checks and updates, the same
// sequential sums, the same tanhf/log2f/exp2f, the log-domain leave-one-out
// and the reference's piecewise-linear platanh with true divisions.
//
// One block of 128 threads (four warps) per codeword row. Thread t owns
// bit t (so a __ballot_sync of a warp's hard decisions is one 32-bit word
// of the codeword), check row t, CRC row t, and the real edges t, t + 128
// and t + 256 of the 384 (the tables list them in (check, slot) order,
// padding slots dropped). Each of up to max_iters iterations:
//   zn = llr + tov[e0] + tov[e1] + tov[e2]   (the bit's edges in slot order)
//   cw = zn > 0, four words by ballot; each of the 38 parity checks and 13
//   CRC rows is the parity of __popc(mask & cw); hard errors =
//   __popc(cw ^ (llr > 0)); success = no failed check and hard errors < 18:
//   the row writes its outputs and its block leaves (the outputs freeze at
//   the first success)
//   t[e] = tanh(-(zn[bit(e)] - tov[e]) / 2) and log2(max(|t|, 2^-80)) per
//   edge; per check row, one thread sums the log2 terms in slot order and
//   counts the negative t; then per edge
//   tov[e] = 2 * platanh(-(sign * exp2(sum - log2|t_e|))), sign from the
//   parity of the row's other negatives.
// A row marked invalid can never succeed, so its block writes the zero
// outputs at once, without iterating or reading the tables.
//
// What bounds it on the H100: the three precise special functions per edge
// and update (tanhf, log2f, exp2f), 1152 per row and iteration; device
// memory is 512 B of LLRs in and 140 B out per row. The design spends every
// thread on those (three real edges each: no idle lanes, no padding slots),
// keeps every message in the block's 5.3 KB of shared memory, replaces the
// serial parity and CRC loops with ballots and popcounts (five barriers per
// iteration), and frees a decoded or invalid row's block at once. Each
// thread reads its 13 words of the code's tables (its bit's edges, its
// edges' bits and checks, its check's edge range, its parity and CRC masks)
// once per row through the read-only cache into registers: the 3 KB of
// tables that every block reads stay in the SM's L1, and the iterations
// load no table from shared memory. Measured against the alternatives
// (PERF.md): the tables staged into shared memory per row, or once per
// block of 2 to 8 rows (each row on its own named barrier), and the tables
// in __constant__ memory (whose lanes read different words, so the
// constant cache serialises them) were each slower at one window's 256
// rows and at 8 windows' 2048; a warp per row (no block barriers, but
// twelve edges per lane in sequence) was slower at every batch.
//
// kFast (DecoderConfig.fast_math; ops/precision.py, B3) rounds where the JAX
// kernel's fast mode does (pallas_ldpc.py:153-155, 186-190, 199-207): the
// three check-to-bit messages are rounded to bf16 and summed in FP32 before
// zn = llr + their sum; a bit-to-check message reads zn rounded to bf16
// (once per bit, in shared memory) minus the unrounded tov; each edge
// splits its log2 term into two bf16 parts, the row sum is the sum of the
// high parts plus the sum of the low parts, and it reaches the edges as its
// own two bf16 parts. Parity, CRC, tanhf, exp2f and platanh are the FP32
// instantiation's. Every output equals bp_decode_plain(fast) as in FP32.
// An edge keeps its two parts in one word, so that one shared load feeds
// both sums of a check and the row's state is the FP32 instantiation's
// size. The kFast instantiation is latency-bound like the FP32 one, and
// its roundings lengthen the per-bit sum and the check sums (PERF.md
// section 6). Measured no faster than the two arrays: a check's two sums
// on two threads (joined where the edges read them, or by a shuffle), tov
// kept rounded beside it, the roundings by integer operations, and 12 or
// 16 blocks per SM (spills).

#include <type_traits>

#include "common.cuh"

namespace {

using namespace msk;

constexpr int kBits = 128;
constexpr int kChecks = 38;
constexpr int kDegree = 11;  // the most real edges of a check
constexpr int kEdges = 384;  // real edges: 128 bits x 3 checks
constexpr int kWords = kBits / 32;
constexpr int kMsgBits = 77;
constexpr int kCrcBits = 13;
constexpr int kCrcWords = 3;  // message bits 0..76
constexpr int kMaxHardErrors = 18;
constexpr int kThreads = kBits;  // a thread per bit
constexpr int kEdgesPerThread = kEdges / kThreads;

// The row's messages. kFast keeps each log2 term as its two bf16 parts in
// one word (pack_bf16's layout: the high part in the low half).
template <bool kFast>
struct RowState {
  float tov[kEdges];
  float t[kEdges];
  std::conditional_t<kFast, unsigned, float> lt[kEdges];
  float zn[kBits];
  float row_sum[kChecks];
  int row_neg[kChecks];
  unsigned hard_words[kWords];  // each warp's ballot of llr > 0
  unsigned cw_words[kWords];    // and of zn > 0
};

__device__ __forceinline__ float platanh(float x) {
  const float z = fabsf(x);
  const float s = x < 0.f ? -1.f : 1.f;
  if (z <= 0.664f) return x / 0.83f;
  if (z <= 0.9217f) return s * ((z - 0.4064f) / 0.322f);
  if (z <= 0.9951f) return s * ((z - 0.8378f) / 0.0524f);
  if (z <= 0.9998f) return s * ((z - 0.9914f) / 0.0012f);
  return s * 7.f;
}

// The four words of a predicate over the row's bits (bit t of the row is
// bit t % 32 of word t / 32) on every thread, through `shared`. Ends in a
// block barrier.
__device__ __forceinline__ void row_words(bool own, unsigned* shared, unsigned (&words)[kWords]) {
  const unsigned b = __ballot_sync(0xffffffffu, own);
  if ((threadIdx.x & 31) == 0) shared[threadIdx.x >> 5] = b;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kWords; ++k) words[k] = shared[k];
}

// The code's tables, as ops/tables.py packs them: edge (384,) bit | check
// << 8 in (check, slot) order; bit_edges (128,) the bit's three edges, 9
// bits each; row_start (39,) each check's first edge; check_mask (38, 4) and
// crc_mask (13, 3) 32-bit words of the bits of each check and CRC row.
// x as the sum of two bf16 parts, x ~= h + l (about 16 mantissa bits)
__device__ __forceinline__ float split2(float x) {
  const float h = round_bf16(x);
  return h + round_bf16(x - h);
}

// x's two bf16 parts (h, round(x - h)) in one word (the high part in the
// low half), and each back as a float
__device__ __forceinline__ unsigned pack_split2(float x) {
  return pack_bf16(make_float2(x, x - round_bf16(x)));
}

__device__ __forceinline__ float split_high(unsigned w) { return __uint_as_float(w << 16); }

__device__ __forceinline__ float split_low(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

template <bool kFast>
__global__ void __launch_bounds__(kThreads)
bp_kernel(const float* __restrict__ llr, const bool* __restrict__ valid,
          const int* __restrict__ edge, const int* __restrict__ bit_edges,
          const int* __restrict__ row_start, const int* __restrict__ check_mask,
          const int* __restrict__ crc_mask, int8_t* __restrict__ cw_out,
          bool* __restrict__ found_out, int* __restrict__ iters_out,
          int* __restrict__ nerr_out, int max_iters) {
  __shared__ RowState<kFast> st;
  const int row = blockIdx.x;
  const int j = threadIdx.x;
  int8_t* cw_row = cw_out + static_cast<size_t>(row) * kBits;

  if (valid[row]) {
    // this thread's words of the tables, for every iteration
    const int be = __ldg(bit_edges + j);
    int eg[kEdgesPerThread];
#pragma unroll
    for (int i = 0; i < kEdgesPerThread; ++i) eg[i] = __ldg(edge + j + kThreads * i);
    int lo = 0, hi = 0;
    unsigned cmask[kWords] = {}, rmask[kCrcWords] = {};
    if (j < kChecks) {
      lo = __ldg(row_start + j);
      hi = __ldg(row_start + j + 1);
#pragma unroll
      for (int k = 0; k < kWords; ++k) cmask[k] = __ldg(check_mask + j * kWords + k);
    }
    if (j < kCrcBits) {
#pragma unroll
      for (int k = 0; k < kCrcWords; ++k) rmask[k] = __ldg(crc_mask + j * kCrcWords + k);
    }
#pragma unroll
    for (int i = 0; i < kEdgesPerThread; ++i) st.tov[j + kThreads * i] = 0.f;
    const float l = llr[static_cast<size_t>(row) * kBits + j];
    unsigned hard[kWords];
    row_words(l > 0.f, st.hard_words, hard);

    for (int it = 0; it < max_iters; ++it) {
      float z;
      if constexpr (kFast)
        z = l + (round_bf16(st.tov[be & 511]) + round_bf16(st.tov[(be >> 9) & 511]) +
                 round_bf16(st.tov[be >> 18]));
      else
        z = l + st.tov[be & 511] + st.tov[(be >> 9) & 511] + st.tov[be >> 18];
      st.zn[j] = kFast ? round_bf16(z) : z;  // read only by the bit-to-check messages
      unsigned cw[kWords];
      row_words(z > 0.f, st.cw_words, cw);  // its barrier also publishes zn
      int n_err = 0;
#pragma unroll
      for (int k = 0; k < kWords; ++k) n_err += __popc(cw[k] ^ hard[k]);
      bool failed = false;
      if (j < kChecks) {
        int par = 0;
#pragma unroll
        for (int k = 0; k < kWords; ++k) par += __popc(cmask[k] & cw[k]);
        failed = (par & 1) != 0;
      }
      if (j < kCrcBits) {
        int par = 0;
#pragma unroll
        for (int k = 0; k < kCrcWords; ++k) par += __popc(rmask[k] & cw[k]);
        const int bit = (cw[2] >> (kMsgBits - 64 + j)) & 1;  // CRC bits 77..89: word 2
        failed |= (par & 1) != bit;
      }
      if (!__syncthreads_or(failed) && n_err < kMaxHardErrors) {
        cw_row[j] = static_cast<int8_t>(z > 0.f);
        if (j == 0) {
          found_out[row] = true;
          iters_out[row] = it;
          nerr_out[row] = n_err;
        }
        return;
      }

      // bit -> check messages and their log-domain magnitudes
      float lt_own[kEdgesPerThread];
      unsigned neg_own = 0u;
#pragma unroll
      for (int i = 0; i < kEdgesPerThread; ++i) {
        const int e = j + kThreads * i;
        const float te = tanhf(-0.5f * (st.zn[eg[i] & 255] - st.tov[e]));
        lt_own[i] = log2f(fmaxf(fabsf(te), 0x1p-80f));
        st.t[e] = te;
        if constexpr (kFast)
          st.lt[e] = pack_split2(lt_own[i]);
        else
          st.lt[e] = lt_own[i];
        neg_own |= static_cast<unsigned>(te < 0.f) << i;
      }
      __syncthreads();
      // the check sums
      if (j < kChecks) {
        int neg = st.t[lo] < 0.f;
        if constexpr (kFast) {  // the high parts' sum plus the low parts', a word a term
          float Sh = split_high(st.lt[lo]);
          float Sl = split_low(st.lt[lo]);
#pragma unroll
          for (int k = 1; k < kDegree; ++k) {
            if (lo + k < hi) {
              const unsigned w = st.lt[lo + k];
              Sh += split_high(w);
              Sl += split_low(w);
              neg += st.t[lo + k] < 0.f;
            }
          }
          st.row_sum[j] = split2(Sh + Sl);
        } else {
          float S = st.lt[lo];
#pragma unroll
          for (int k = 1; k < kDegree; ++k) {  // unrolled, so that the loads go out together
            if (lo + k < hi) {
              S += st.lt[lo + k];
              neg += st.t[lo + k] < 0.f;
            }
          }
          st.row_sum[j] = S;
        }
        st.row_neg[j] = neg;
      }
      __syncthreads();
      // check -> bit messages (leave-one-out)
#pragma unroll
      for (int i = 0; i < kEdgesPerThread; ++i) {
        const int e = j + kThreads * i;
        const int r = eg[i] >> 8;
        const float mag = exp2f(st.row_sum[r] - lt_own[i]);
        const int others = st.row_neg[r] - static_cast<int>((neg_own >> i) & 1u);
        const float loo = (1.f - 2.f * static_cast<float>(others & 1)) * mag;
        st.tov[e] = 2.f * platanh(-loo);
      }
      __syncthreads();
    }
  }
  cw_row[j] = 0;
  if (j == 0) {
    found_out[row] = false;
    iters_out[row] = 0;
    nerr_out[row] = 0;
  }
}

}  // namespace

// Plain C interface (ctypes). Launches on `stream`; fast != 0: the kFast
// instantiation. Returns cudaGetLastError().
extern "C" int msk_bp(const void* llr, const void* valid, const void* edge,
                      const void* bit_edges, const void* row_start, const void* check_mask,
                      const void* crc_mask, void* cw_out, void* found_out, void* iters_out,
                      void* nerr_out, int rows, int max_iters, int fast, void* stream) {
  if (rows <= 0) return 0;
  const auto kernel = fast ? bp_kernel<true> : bp_kernel<false>;
  kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(llr), static_cast<const bool*>(valid),
      static_cast<const int*>(edge), static_cast<const int*>(bit_edges),
      static_cast<const int*>(row_start), static_cast<const int*>(check_mask),
      static_cast<const int*>(crc_mask), static_cast<int8_t*>(cw_out),
      static_cast<bool*>(found_out), static_cast<int*>(iters_out),
      static_cast<int*>(nerr_out), max_iters);
  return static_cast<int>(cudaGetLastError());
}
