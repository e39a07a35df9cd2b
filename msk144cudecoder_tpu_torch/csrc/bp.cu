// Kernel B3: LDPC(128,90) belief propagation with the CRC-13 gate.
//
// Replaces msk144cudecoder_tpu/ops/pallas_ldpc.py::_bp_kernel (launched by
// bp_decode_pallas). Same result as the plain torch version in ops/ldpc.py
// (bp_decode_plain): the same order of checks and updates, the same
// sequential sums, the log-domain leave-one-out and the reference's
// piecewise-linear platanh.
//
// One block of 128 threads per codeword row, thread j owning bit j (the
// layout of the CUDA original's BP kernel), with the edge tables (NM: the
// bit of each of the 38 x 11 check slots, -1 for padding; MN: the 3 edges
// of each bit) and the CRC matrix in shared memory. Each of up to max_iters
// iterations:
//   zn = llr + tov[e0] + tov[e1] + tov[e2]; cw = zn > 0
//   the 38 parity checks (threads 0-37), the CRC of cw[:77] against
//   cw[77:90] (threads 64-76), hard errors = #(cw != llr > 0); success =
//   no failed check, hard errors < 18 and `valid`: the row writes its
//   outputs and the block leaves (the outputs freeze at the first success)
//   t[e] = tanh(-(zn[bit(e)] - tov[e]) / 2); per check row the sum of
//   log2(max(|t|, 2^-80)) and the count of negative t; then
//   tov[e] = 2 * platanh(-(sign * exp2(sum - log2|t_e|))), sign from the
//   parity of the row's other negatives.
//
// What bounds it on the H100: nothing in device memory (512 B of LLRs in,
// 140 B out per row); each iteration is a few hundred FLOPs and three
// block barriers per row, so barrier latency and the tanhf/log2f/exp2f
// throughput bound it. The design keeps every message in shared memory for
// all iterations and lets a decoded row's block exit at once, so rows that
// decode early free their SM. The Pallas kernel's one-hot selection
// matmuls and bf16 mantissa splits are TPU devices and are gone: an edge
// is an index.

#include "common.cuh"

namespace {

using namespace msk;

constexpr int kBits = 128;
constexpr int kChecks = 38;
constexpr int kDegree = 11;
constexpr int kEdges = kChecks * kDegree;  // 418, 11 slots per check
constexpr int kMsgBits = 77;
constexpr int kCrcBits = 13;
constexpr int kCrcLane = 64;  // first thread of the CRC checks
constexpr int kMaxHardErrors = 18;

__device__ __forceinline__ float platanh(float x) {
  const float z = fabsf(x);
  const float s = x < 0.f ? -1.f : 1.f;
  if (z <= 0.664f) return x / 0.83f;
  if (z <= 0.9217f) return s * ((z - 0.4064f) / 0.322f);
  if (z <= 0.9951f) return s * ((z - 0.8378f) / 0.0524f);
  if (z <= 0.9998f) return s * ((z - 0.9914f) / 0.0012f);
  return s * 7.f;
}

__global__ void __launch_bounds__(kBits)
bp_kernel(const float* __restrict__ llr, const bool* __restrict__ valid,
          const int* __restrict__ nm, const int* __restrict__ mn_edge,
          const uint8_t* __restrict__ crc, int8_t* __restrict__ cw_out,
          bool* __restrict__ found_out, int* __restrict__ iters_out,
          int* __restrict__ nerr_out, int max_iters) {
  __shared__ int s_nm[kEdges];
  __shared__ uint8_t s_crc[kCrcBits * kMsgBits];
  __shared__ float tov[kEdges];
  __shared__ float t_e[kEdges];
  __shared__ float lt_e[kEdges];
  __shared__ float zn[kBits];
  __shared__ int cw[kBits];
  __shared__ float row_sum[kChecks];
  __shared__ int row_neg[kChecks];

  const int row = blockIdx.x;
  const int j = threadIdx.x;
  for (int e = j; e < kEdges; e += kBits) {
    s_nm[e] = nm[e];
    tov[e] = 0.f;
  }
  for (int i = j; i < kCrcBits * kMsgBits; i += kBits) s_crc[i] = crc[i];
  const float l = llr[static_cast<size_t>(row) * kBits + j];
  const int hard = l > 0.f;
  const int e0 = mn_edge[3 * j];
  const int e1 = mn_edge[3 * j + 1];
  const int e2 = mn_edge[3 * j + 2];
  const bool row_valid = valid[row];
  __syncthreads();

  for (int it = 0; it < max_iters; ++it) {
    const float z = l + tov[e0] + tov[e1] + tov[e2];
    const int bit = z > 0.f;
    zn[j] = z;
    cw[j] = bit;
    __syncthreads();

    int failed = 0;
    if (j < kChecks) {
      int par = 0;
      for (int k = 0; k < kDegree; ++k) {
        const int b = s_nm[j * kDegree + k];
        if (b >= 0) par ^= cw[b];
      }
      failed = par;
    } else if (j >= kCrcLane && j < kCrcLane + kCrcBits) {
      const int r = j - kCrcLane;
      int par = 0;
      for (int i = 0; i < kMsgBits; ++i) par ^= s_crc[r * kMsgBits + i] & cw[i];
      failed = par != cw[kMsgBits + r];
    }
    const int n_failed = __syncthreads_count(failed);
    const int n_err = __syncthreads_count(bit != hard);
    if (n_failed == 0 && n_err < kMaxHardErrors && row_valid) {
      cw_out[static_cast<size_t>(row) * kBits + j] = static_cast<int8_t>(bit);
      if (j == 0) {
        found_out[row] = true;
        iters_out[row] = it;
        nerr_out[row] = n_err;
      }
      return;  // uniform across the block: its outputs are frozen
    }

    // bit -> check messages and their log-domain magnitudes
    for (int e = j; e < kEdges; e += kBits) {
      const int b = s_nm[e];
      float t = 1.f;
      if (b >= 0) t = tanhf(-0.5f * (zn[b] - tov[e]));
      t_e[e] = t;
      lt_e[e] = log2f(fmaxf(fabsf(t), 0x1p-80f));
    }
    __syncthreads();
    if (j < kChecks) {
      float S = lt_e[j * kDegree];
      int neg = (s_nm[j * kDegree] >= 0 && t_e[j * kDegree] < 0.f);
      for (int k = 1; k < kDegree; ++k) {
        const int e = j * kDegree + k;
        S += lt_e[e];
        neg += (s_nm[e] >= 0 && t_e[e] < 0.f);
      }
      row_sum[j] = S;
      row_neg[j] = neg;
    }
    __syncthreads();
    // check -> bit messages (leave-one-out), padded edges stay zero
    for (int e = j; e < kEdges; e += kBits) {
      if (s_nm[e] < 0) continue;
      const int r = e / kDegree;
      const float mag = exp2f(row_sum[r] - lt_e[e]);
      const int others = row_neg[r] - (t_e[e] < 0.f);
      const float loo = (1.f - 2.f * static_cast<float>(others & 1)) * mag;
      tov[e] = 2.f * platanh(-loo);
    }
    __syncthreads();
  }
  cw_out[static_cast<size_t>(row) * kBits + j] = 0;
  if (j == 0) {
    found_out[row] = false;
    iters_out[row] = 0;
    nerr_out[row] = 0;
  }
}

}  // namespace

// Plain C interface (ctypes). Launches on `stream`; returns cudaGetLastError().
extern "C" int msk_bp(const void* llr, const void* valid, const void* nm, const void* mn_edge,
                      const void* crc, void* cw_out, void* found_out, void* iters_out,
                      void* nerr_out, int rows, int max_iters, void* stream) {
  if (rows <= 0) return 0;
  bp_kernel<<<rows, kBits, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(llr), static_cast<const bool*>(valid),
      static_cast<const int*>(nm), static_cast<const int*>(mn_edge),
      static_cast<const uint8_t*>(crc), static_cast<int8_t*>(cw_out),
      static_cast<bool*>(found_out), static_cast<int*>(iters_out),
      static_cast<int*>(nerr_out), max_iters);
  return static_cast<int>(cudaGetLastError());
}
