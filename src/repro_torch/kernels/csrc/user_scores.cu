// K1: fused u·q + rank-table lookup, §4.3 step 1 of the query.
//
// Replaces the TPU kernel repro/kernels/user_scores.py
// (_bound_rank_batched_kernel / bound_ranks_batched_kernel_call, and its
// B = 1 twin _bound_rank_kernel, which is this kernel called with B = 1).
//
// For each user u and query b (B <= 16 per launch):
//   s    = u·q_b, a fixed-order f32 FMA dot product
//   idx  = #{j < tau : t_j <= s}
//   r_up = T[idx-1], or m+1 when idx = 0;  r_lo = T[idx], or 1 when idx = tau
//   est  = lerp between the bracketing thresholds inside the grid,
//          margin-decayed outside it, clipped to [r_lo, r_up], minus the
//          sub-unit tie-break 0.5·m_above/(1+m_above)
// literally as the plain version (repro_torch/core/query.py
// lookup_bounds_batch).
//
// Design: one warp per user, Qᵀ in shared memory for the whole block.
// The query count NB is a template parameter (1, 2, 4, 8 or 16; a launch
// takes the smallest that holds its B), so a single query computes one
// dot product, not sixteen. The warp loads the user row and the thresholds row coalesced,
// a whole chunk per lane before using any of it, and the first thresholds
// chunk together with the user row, so that many loads are in flight.
// Lane l accumulates u·q_b over k = l, l+32, ... with fmaf; the 32
// partial sums of every query reduce by recursive halving, which pairs
// the same lanes in the same order as an xor butterfly, so a score is
// bitwise the same at every NB. After it, the 32 / NB lanes of query b
// hold u·q_b. The thresholds row is ascending (the build's grid), so idx
// is a search, as the plain version's searchsorted, not τ·NB compares:
// for one query, two rounds of warp-wide probes in global memory (16
// segment ends, then the one segment), which read about 1/16 of the row;
// for several, a binary search by every lane of each 512-float chunk of
// the row, staged in the warp's shared memory.
// The first lane of each query's group finishes that query. Ragged n, d,
// tau and B are masked here; nothing is padded.
//
// Qᵀ lives in shared memory whole while d·stride fits in the default 48
// KB (d <= 409 at 16 queries); a larger d streams it through in chunks
// of 256 rows, the block synchronising between chunks. A chunk is a
// multiple of 32 rows, so lane l still accumulates k = l, l+32, ... in
// ascending order with one fmaf chain, and every score is bitwise the
// same whole or streamed.
//
// K6 (k6_bound_ranks_masked) is this kernel behind a row map. It replaces
// the TPU kernel repro/kernels/user_scores.py
// bound_ranks_batched_masked_kernel_call, the masked grid of block
// pruning: the warp that owns compact row r reads global row
// ids[r / block_n]·block_n + r % block_n, and writes compact row r of
// the outputs. A compact row past n (the tail block's padding) is
// written as m + 2 in all three outputs. Every other row computes
// exactly what K1 computes for that user, so the kept tiles of K6 are
// bitwise K1's outputs on the same rows.
#include <cuda_runtime.h>
#include <math.h>

#include "step1_common.cuh"

namespace {

constexpr size_t kSmemDefault = 48 * 1024;

// rows: compact rows to compute (n without a row map); ids: the row map
// (nullptr: identity), one id per block_n rows; qrows: rows of Qᵀ in
// shared memory at once. STREAM is qrows < d: only then does the loop
// hold block barriers, which would otherwise fence the compiler's
// scheduling of the loads of consecutive users. MASKED is ids != nullptr
// (K6): without it every row is a live user, and K1's loop is free of
// the map's dependent loads and branches.
template <int NB, bool STREAM, bool MASKED>
__global__ void __launch_bounds__(kWarps * 32)
bound_ranks_kernel(const float* __restrict__ U, const float* __restrict__ Q,
                   const float* __restrict__ thr,
                   const float* __restrict__ tab, float* __restrict__ r_lo,
                   float* __restrict__ r_up, float* __restrict__ est, int n,
                   int d, int B, int tau, int ldo, float m_plus_1,
                   const int* __restrict__ ids, int block_n, int rows,
                   int qrows) {
  constexpr int kShift = 5 - log2_nb<NB>();  // lanes per query: 1 << kShift
  extern __shared__ __align__(16) float qs[];  // (qrows, stride): qs[k][b]
  float* ts = qs + qrows * q_stride<NB>() + (threadIdx.x >> 5) * kTile;
  if constexpr (!STREAM) {
    stage_q<NB>(qs, Q, B, d, 0, d);
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int my_b = lane >> kShift;
  const bool finisher = (lane & ((1 << kShift) - 1)) == 0 && my_b < B;
  const float ftau = (float)tau;

  // every warp of a block runs the same iterations, so that a streamed
  // Qᵀ can synchronise the block; a warp without a row only stages
  for (int r0 = blockIdx.x * kWarps; r0 < rows;
       r0 += gridDim.x * kWarps) {
    const int r = r0 + warp;
    if (!STREAM && r >= rows) break;
    int user = r;
    bool live = r < rows;  // a live row computes a user
    if constexpr (MASKED) {
      user = r < rows ? ids[r / block_n] * block_n + r % block_n : n;
      live = user < n;
      if (r < rows && !live && finisher) {  // past n: m + 2
        const size_t o = (size_t)r * ldo + my_b;
        r_lo[o] = r_up[o] = est[o] = m_plus_1 + 1.f;
      }
    }
    if (!STREAM && !live) continue;
    const float* u = U + (size_t)user * d;
    const float* t = thr + (size_t)user * tau;
    // the first chunk of thresholds does not depend on the scores: its
    // loads go out now and overlap those of the user row
    float tv[kTChunk];
    if constexpr (NB > 1) {
      if (live) {
#pragma unroll
        for (int i = 0; i < kTChunk; ++i) {
          const int j = lane + 32 * i;
          tv[i] = j < tau ? t[j] : 0.f;
        }
      }
    }
    float acc[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[b] = 0.f;
    if constexpr (STREAM) {
      for (int c0 = 0; c0 < d; c0 += qrows) {
        const int c1 = min(d, c0 + qrows);
        __syncthreads();  // every warp is done with the previous chunk
        stage_q<NB>(qs, Q, B, d, c0, c1 - c0);
        __syncthreads();
        if (live) dot_chunk<NB>(acc, u, qs, c0, c1, lane);
      }
      if (!live) continue;
    } else {
      dot_chunk<NB>(acc, u, qs, 0, d, lane);
    }
    halve<NB, NB, 16>(acc, lane);
    const float s = acc[0];  // u·q_{my_b}

    int idx = 0;
    if constexpr (NB == 1) {
      // one query: probe the last threshold of each of 16 segments, then
      // count inside the segment that holds s — about 1/16 of the row
      const int g = (tau + 15) / 16;
      const int p = (lane + 1) * g - 1;
      const bool below = lane < 16 && p < tau && t[p] <= s;
      const int base = __popc(__ballot_sync(kFull, below)) * g;
      const int end = min(base + g, tau);
      idx = base;
      for (int j0 = base; j0 < end; j0 += 32) {
        const int j = j0 + lane;
        idx += __popc(__ballot_sync(kFull, j < end && t[j] <= s));
      }
    } else {
      // several queries: each chunk of the row, staged in shared memory,
      // gives its count #{t_j <= s} by a branchless binary search
      for (int j0 = 0;;) {
        const int len = min(kTile, tau - j0);
        __syncwarp();  // the previous chunk's searches are done
#pragma unroll
        for (int i = 0; i < kTChunk; ++i) ts[lane + 32 * i] = tv[i];
        __syncwarp();
        int pos = 0;
#pragma unroll
        for (int step = kTile; step > 0; step >>= 1)
          if (pos + step <= len && ts[pos + step - 1] <= s) pos += step;
        idx += pos;
        j0 += kTile;
        if (j0 >= tau) break;
#pragma unroll
        for (int i = 0; i < kTChunk; ++i) {
          const int j = j0 + lane + 32 * i;
          tv[i] = j < tau ? t[j] : 0.f;
        }
      }
    }

    if (finisher) {
      const float* tb = tab + (size_t)user * tau;
      const int up_col = min(max(idx - 1, 0), tau - 1);
      const int lo_col = min(idx, tau - 1);
      const float rup = idx == 0 ? m_plus_1 : tb[up_col];
      const float rlo = idx == tau ? 1.f : tb[lo_col];
      const float lo_thr = t[up_col], hi_thr = t[lo_col];
      const float span = fmaxf(hi_thr - lo_thr, 1e-12f);
      const float frac = fminf(fmaxf((s - lo_thr) / span, 0.f), 1.f);
      const bool interior = idx > 0 && idx < tau;
      const float est_in = rup + (rlo - rup) * frac;
      const float e_lo = t[0], e_hi = t[tau - 1];
      const float rng = fmaxf(e_hi - e_lo, 1e-12f);
      const float m_above = fmaxf(s - e_hi, 0.f) / rng;
      const float m_below = fmaxf(e_lo - s, 0.f) / rng;
      const float est_above = 1.f + (rup - 1.f) / (1.f + ftau * m_above);
      const float est_below =
          m_plus_1 - (m_plus_1 - rlo) * expf(-ftau * m_below);
      float e = interior ? est_in : (idx == tau ? est_above : est_below);
      e = fminf(fmaxf(e, rlo), rup);
      e = e - 0.5f * m_above / (1.f + m_above);
      const size_t o = (size_t)r * ldo + my_b;
      r_lo[o] = rlo;
      r_up[o] = rup;
      est[o] = e;
    }
  }
}

template <int NB>
int launch(const float* U, const float* Q, const float* thr,
           const float* tab, float* r_lo, float* r_up, float* est, int n,
           int d, int B, int tau, int ldo, float m_plus_1, const int* ids,
           int block_n, int rows, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int want = (rows + kWarps - 1) / kWarps;
  const int blocks = want < sms * 8 ? want : sms * 8;
  const size_t tiles = (size_t)kWarps * kTile;
  const int qrows =
      ((size_t)d * q_stride<NB>() + tiles) * sizeof(float) <= kSmemDefault
          ? d
          : kQChunk;
  const size_t smem = ((size_t)qrows * q_stride<NB>() + tiles) * sizeof(float);
  auto kernel =
      qrows < d ? (ids ? bound_ranks_kernel<NB, true, true>
                       : bound_ranks_kernel<NB, true, false>)
                : (ids ? bound_ranks_kernel<NB, false, true>
                       : bound_ranks_kernel<NB, false, false>);
  kernel<<<blocks, kWarps * 32, smem, stream>>>(
      U, Q, thr, tab, r_lo, r_up, est, n, d, B, tau, ldo, m_plus_1, ids,
      block_n, rows, qrows);
  return (int)cudaGetLastError();
}

int dispatch(const float* U, const float* Q, const float* thr,
             const float* tab, float* r_lo, float* r_up, float* est, int n,
             int d, int B, int tau, int ldo, float m_plus_1, const int* ids,
             int block_n, int rows, void* stream) {
  if (rows <= 0 || B <= 0) return 0;
  if (B > kMaxB || tau < 1 || n <= 0 || d <= 0 || (ids && block_n <= 0))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (B == 1)
    return launch<1>(U, Q, thr, tab, r_lo, r_up, est, n, d, B, tau, ldo,
                     m_plus_1, ids, block_n, rows, st);
  if (B == 2)
    return launch<2>(U, Q, thr, tab, r_lo, r_up, est, n, d, B, tau, ldo,
                     m_plus_1, ids, block_n, rows, st);
  if (B <= 4)
    return launch<4>(U, Q, thr, tab, r_lo, r_up, est, n, d, B, tau, ldo,
                     m_plus_1, ids, block_n, rows, st);
  if (B <= 8)
    return launch<8>(U, Q, thr, tab, r_lo, r_up, est, n, d, B, tau, ldo,
                     m_plus_1, ids, block_n, rows, st);
  return launch<16>(U, Q, thr, tab, r_lo, r_up, est, n, d, B, tau, ldo,
                    m_plus_1, ids, block_n, rows, st);
}

}  // namespace

// Outputs are user-major with row stride ldo: out[user * ldo + b].
extern "C" int k1_bound_ranks(const float* U, const float* Q,
                              const float* thr, const float* tab,
                              float* r_lo, float* r_up, float* est, int n,
                              int d, int B, int tau, int ldo,
                              float m_plus_1, void* stream) {
  return dispatch(U, Q, thr, tab, r_lo, r_up, est, n, d, B, tau, ldo,
                  m_plus_1, nullptr, 1, n, stream);
}

// K6: K1 over the nk tiles of block_n rows named by ids (nk,); outputs
// are compact, (nk·block_n) rows with row stride ldo, in list order.
extern "C" int k6_bound_ranks_masked(const float* U, const float* Q,
                                     const float* thr, const float* tab,
                                     const int* ids, float* r_lo,
                                     float* r_up, float* est, int n, int d,
                                     int B, int tau, int ldo,
                                     float m_plus_1, int nk, int block_n,
                                     void* stream) {
  return dispatch(U, Q, thr, tab, r_lo, r_up, est, n, d, B, tau, ldo,
                  m_plus_1, ids, block_n, nk * block_n, stream);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
