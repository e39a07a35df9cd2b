// Kernel B2: the survivor demod.
//
// Replaces msk144cudecoder_tpu/ops/pallas_survivor.py::_survivor_kernel
// (launched by demod_survivors, operands from survivor_params) and its tail
// ops/pallas_demod.py::mf_tail. Same result as the plain torch version in
// ops/survivor.py (demod_survivors_plain).
//
// One block per survivor row (window b, survivor s), all B*S rows in one
// launch, each row with its own pattern p:
//   gamma[m, 0]   = mask_p[m] * (W[f, 128*(pos/128)] * W[f, pos%128]) * W[f, 864m]
//   gamma[m, k+1] = gamma[m, k] * conj(1 + chi_f)
//   frame[l] = (sum_m c[(pos + 864m + l) mod N] * gamma[m, k]) * W[f, l],
//              k = (pos + 864m + l) / N,  l < 864
// then in shared memory: s = sum frame * conj(cb42) over samples [0, 42) and
// [336, 378); cfac = conj(s)/|s| (mf_tail); the 144 matched-filter softbits
// of the derotated frame: Q at column 2q from the imaginary part over rows
// (858 + 12q + i) mod 864, I at column 2q+1 from the real part over rows
// 12q + i; mean and variance over the 144 give scale = 2/(ssig * 0.36);
// nbadsync counts the sign mismatches against the sync word at bits 0-7
// and 56-63; out come the scaled data softbits [8:56) + [64:144).
// Every phase is a table value (W, chi, cb42), none an in-kernel sincos.
//
// What bounds it on the H100: per row about 6 * 864 complex loads of the
// window (from L1/L2: a window is 41 KB and is shared by its 512 rows) and a
// few thousand FLOPs, so latency and the loads, not arithmetic. The design
// gives each row a block that builds its frame in shared memory straight
// from the window with one modulo per sample: none of the Pallas kernel's
// one-hot extraction matmuls, offset-class sliding matrices or lane-roll
// shifts, which exist because a TPU gather runs on its scalar core.

#include "common.cuh"

namespace {

using namespace msk;

constexpr int kThreads = 256;
constexpr int kSoftbits = 144;

__global__ void __launch_bounds__(kThreads)
survivor_kernel(const float2* __restrict__ c, const float2* __restrict__ W,
                const float2* __restrict__ chi, const int* __restrict__ pos,
                const int* __restrict__ f_idx, const int* __restrict__ p_idx,
                const float2* __restrict__ sync_conj, const float* __restrict__ pp12,
                const int* __restrict__ masks, const int* __restrict__ sync_pm,
                float* __restrict__ sb_out, int* __restrict__ nbad_out, int S, int F) {
  __shared__ float2 frame[kFrameLen];
  __shared__ float2 gam[kFrames][3];
  __shared__ int active[kFrames];
  __shared__ float sb[kSoftbits];
  __shared__ float2 sync_part[2];
  __shared__ float scratch[kThreads / 32];

  const int row = blockIdx.x;
  const int b = row / S;
  const int ps = pos[row];
  const int f = f_idx[row];
  const int p = p_idx[row];
  if (ps < 0 || ps >= kWindowLen || f < 0 || f >= F || p < 0 || p >= 8) {
    // an index outside the tables: no read, the row can never survive
    if (threadIdx.x < 128) sb_out[static_cast<size_t>(row) * 128 + threadIdx.x] = 0.f;
    if (threadIdx.x == 0) nbad_out[row] = 17;
    return;
  }
  const float2* cw = c + static_cast<size_t>(b) * kWindowLen;
  const float2* Wf = W + static_cast<size_t>(f) * kWindowLen;

  if (threadIdx.x < kFrames) {
    const int m = threadIdx.x;
    const int mk = masks[p * kFrames + m];
    const float2 w_pos = cmul(Wf[128 * (ps / 128)], Wf[ps % 128]);
    const float2 ch = chi[f];
    const float2 phi = make_float2(1.f + ch.x, -ch.y);  // conj(1 + chi)
    const float2 g0 = cmul(cmul(make_float2(static_cast<float>(mk), 0.f), w_pos),
                           Wf[kFrameLen * m]);
    const float2 g1 = cmul(g0, phi);
    gam[m][0] = g0;
    gam[m][1] = g1;
    gam[m][2] = cmul(g1, phi);
    active[m] = mk != 0;
  }
  __syncthreads();

  for (int l = threadIdx.x; l < kFrameLen; l += kThreads) {
    float2 acc = make_float2(0.f, 0.f);
    for (int m = 0; m < kFrames; ++m) {
      if (!active[m]) continue;  // a zero gamma adds an exact zero
      int idx = ps + kFrameLen * m + l;
      int k = 0;
      while (idx >= kWindowLen) {
        idx -= kWindowLen;
        ++k;
      }
      acc = cadd(acc, cmul(cw[idx], gam[m][k]));
    }
    frame[l] = cmul(acc, Wf[l]);
  }
  __syncthreads();

  // carrier phase: warp 0 sums the first sync region, warp 1 the second
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp < 2) {
    const int base = warp == 0 ? 0 : kSecondSync;
    float2 v = make_float2(0.f, 0.f);
    for (int i = lane; i < kSyncTaps; i += 32) v = cadd(v, cmul(frame[base + i], sync_conj[i]));
    v.x = warp_sum(v.x);
    v.y = warp_sum(v.y);
    if (lane == 0) sync_part[warp] = v;
  }
  __syncthreads();
  const float2 s = cadd(sync_part[0], sync_part[1]);
  const float inv = 1.f / fmaxf(sqrtf(s.x * s.x + s.y * s.y), 1e-30f);
  const float cre = s.x * inv;  // cfac = conj(s) / |s|
  const float cim = -s.y * inv;

  float v = 0.f;
  if (threadIdx.x < kSoftbits) {
    const int q = threadIdx.x >> 1;
    for (int i = 0; i < 12; ++i) {
      if ((threadIdx.x & 1) == 0) {  // Q rail: imag of the derotated frame
        const float2 z = frame[(858 + 12 * q + i) % kFrameLen];
        v += (z.x * cim + z.y * cre) * pp12[i];
      } else {  // I rail: real part
        const float2 z = frame[12 * q + i];
        v += (z.x * cre - z.y * cim) * pp12[i];
      }
    }
    sb[threadIdx.x] = v;
  }
  const float sav = block_sum<kThreads>(v, scratch) / static_cast<float>(kSoftbits);
  const float s2av = block_sum<kThreads>(v * v, scratch) / static_cast<float>(kSoftbits);
  const float ssig = sqrtf(fmaxf(s2av - sav * sav, 1e-30f));
  const float scale = 2.f / (ssig * 0.36f);  // 2 / (ssig * sigma^2), sigma = 0.6

  const int t = threadIdx.x;
  bool bad = false;
  if (t < 8 || (t >= 56 && t < 64)) {
    const int hard = sb[t] < 0.f ? -1 : 1;
    bad = hard != sync_pm[t & 7];
  }
  const int nbad = __syncthreads_count(bad);
  const size_t out = static_cast<size_t>(row) * 128;
  if (t >= 8 && t < 56) sb_out[out + t - 8] = scale * sb[t];
  if (t >= 64 && t < kSoftbits) sb_out[out + t - 16] = scale * sb[t];
  if (t == 0) nbad_out[row] = nbad;
}

}  // namespace

// Plain C interface (ctypes). Launches on `stream`; returns cudaGetLastError().
extern "C" int msk_survivor(const void* c, const void* W, const void* chi, const void* pos,
                            const void* f_idx, const void* p_idx, const void* sync_conj,
                            const void* pp12, const void* masks, const void* sync_pm,
                            void* sb_out, void* nbad_out, int n_win, int S, int F,
                            void* stream) {
  if (n_win <= 0 || S <= 0) return 0;
  survivor_kernel<<<n_win * S, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(c), static_cast<const float2*>(W),
      static_cast<const float2*>(chi), static_cast<const int*>(pos),
      static_cast<const int*>(f_idx), static_cast<const int*>(p_idx),
      static_cast<const float2*>(sync_conj), static_cast<const float*>(pp12),
      static_cast<const int*>(masks), static_cast<const int*>(sync_pm),
      static_cast<float*>(sb_out), static_cast<int*>(nbad_out), S, F);
  return static_cast<int>(cudaGetLastError());
}
