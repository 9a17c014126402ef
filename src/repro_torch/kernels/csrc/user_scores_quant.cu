// K4 and K5: fused u·q + certified rank-table lookup on a quantized
// table, §4.3 step 1 of the query at the bf16 and int8 storage specs.
//
// K4 replaces the TPU kernel repro/kernels/user_scores.py
// _bound_rank_batched_bf16_kernel, K5 _bound_rank_batched_int8_kernel
// (both through bound_ranks_batched_quant_kernel_call). Each computes,
// literally as its plain version (repro_torch/core/query.py
// _lookup_bounds_bf16 / _lookup_bounds_int8 after user_scores_batch),
// for each user u and query b (B <= 16 per launch):
//   s     = Σ_k u_k·q_bk, a fixed-order f32 fmaf chain over the stored row
//           widened to f32 (bf16, int8 or f32 rows), times the user's
//           scale (K5)
//   slack = row_slack·‖q_b‖₁, with ‖q_b‖₁ given by the caller
// K4 (bf16 thresholds/table):
//   idx_hi = #{t̃ <= bf16(s + slack)}, idx_lo = #{t̃ < bf16(s − slack)}
//   (round to nearest even; bf16 → f32 is exact and monotone, so the
//   compares run in f32); r↑ = T̃[idx_lo−1]·(1+ε) or m+1 at idx_lo = 0;
//   r↓ = T̃[idx_hi]·(1−ε) or 1 at idx_hi = τ
// K5 (int8 table, thresholds never read):
//   s' = (s − off_t)/sc_t, δ' = slack/sc_t, dev = thr_dev + pad,
//   idx = clip(floor((v + 127)/Δ), −1, τ) + 1 at v = (s' ± δ') ± dev;
//   table codes dequantize as code·sc + off and widen by (½+pad)·sc;
//   the estimate's thresholds are the grid (cΔ − 127)·sc_t + off_t
// est interpolates between the thresholds around idx_hi with the
// unshifted score, as query._est_from_grid. The constants Δ, pad, ½+pad
// and 1±ε come from the host, each rounded once from double to f32 as
// the reference's literals are.
//
// Bound on the card: memory. K4 reads the bf16 user row (2d B) and, per
// query, two searches of the bf16 thresholds row and two table gathers;
// K5 reads the int8 row (d B), seven per-user f32 scalars and two int8
// table codes per query, and no thresholds at all.
//
// Design: K1's (csrc/user_scores.cu): one warp per user, Qᵀ in shared
// memory, the query count NB a template parameter (1, 2, 4, 8, 16), the
// partial sums reduced by recursive halving, so a score is bitwise the
// same at every NB. K4 searches the thresholds row twice: for one query
// by warp-wide probes in global memory (16 segment ends, then the one
// segment); for several by a binary search of each 512-value chunk of
// the row, staged as f32 in the warp's shared memory, the two searches
// of a query on two of its lanes. K5's bucketize is arithmetic.
// The lookup that follows (divisions, exp, gathers) is most of the
// instructions, so it runs on every lane: a warp takes its users in
// batches of 32 / NB, computes their scores (and K4's searches) one user
// at a time, hands each (user, query) to its own lane, and then all 32
// lanes finish their pairs at once. A lane loads its user's scalars
// (slack, scales, offsets, edge thresholds) before the batch's scores.
// Ragged n, d, tau and B are masked; nothing is padded. As in K1, Qᵀ
// streams through shared memory in chunks of 256 rows where it does not
// fit whole, which keeps each lane's fmaf order and so every score.
//
// K7 (k7_bound_ranks_bf16_masked, k7_bound_ranks_int8_masked) is this
// kernel behind K6's row map. It replaces the TPU kernel
// repro/kernels/user_scores.py bound_ranks_batched_quant_masked_kernel_call:
// compact row r computes global row ids[r / block_n]·block_n + r % block_n,
// whose per-row vectors (slack, scales, offsets, thr_dev) are read at the
// same global row, and a compact row past n is written as m + 2 in all
// three outputs. The kept tiles of K7 are bitwise K4's / K5's outputs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;     // users in flight per block, one warp each
constexpr int kMaxB = 16;     // queries per launch
constexpr int kUChunk = 8;    // user-row values each lane loads at once
constexpr int kTChunk = 16;   // thresholds each lane loads at once
constexpr int kTile = 32 * kTChunk;  // thresholds a warp searches at once
constexpr unsigned kFull = 0xffffffffu;
constexpr int kQChunk = 256;  // rows of Qᵀ a streamed chunk holds
constexpr size_t kSmemDefault = 48 * 1024;

enum Kind { kBf16 = 0, kInt8 = 1 };

// Qᵀ row stride in shared memory, as K1: 20 (NB = 16) or 12 (NB = 8)
// floats keep the eight lanes of a quarter-warp on distinct banks.
template <int NB>
__host__ __device__ constexpr int q_stride() { return NB >= 8 ? NB + 4 : NB; }

template <int NB>
__host__ __device__ constexpr int log2_nb() {
  return NB >= 16 ? 4 : NB >= 8 ? 3 : NB >= 4 ? 2 : NB >= 2 ? 1 : 0;
}

// K1's reduction: sum v[b] over the 32 lanes for all b < NB; lane l ends
// with the sum of query l >> (5 - log2 NB) in v[0].
template <int NB, int CUR, int OFF>
__device__ __forceinline__ void halve(float (&v)[NB], int lane) {
  if constexpr (CUR > 1) {
    constexpr int kHalf = CUR / 2;
    const bool upper = (lane & OFF) != 0;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const float send = upper ? v[i] : v[i + kHalf];
      const float keep = upper ? v[i + kHalf] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, OFF);
    }
    halve<NB, kHalf, OFF / 2>(v, lane);
  } else {
#pragma unroll
    for (int off = OFF; off > 0; off >>= 1)
      v[0] += __shfl_xor_sync(kFull, v[0], off);
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// #{j < tau : t_j <= v} (STRICT false) or #{j < tau : t_j < v} (STRICT
// true) of an ascending bf16 row, v the same in every lane: the last
// value of each of 16 segments is probed, then the one segment that holds
// the edge is counted.
template <bool STRICT>
__device__ __forceinline__ int count_probed(const __nv_bfloat16* t, int tau,
                                            float v, int lane) {
  const int g = (tau + 15) / 16;
  const int p = (lane + 1) * g - 1;
  bool in = false;
  if (lane < 16 && p < tau) {
    const float x = __bfloat162float(t[p]);
    in = STRICT ? x < v : x <= v;
  }
  const int base = __popc(__ballot_sync(kFull, in)) * g;
  const int end = min(base + g, tau);
  int idx = base;
  for (int j0 = base; j0 < end; j0 += 32) {
    const int j = j0 + lane;
    bool c = false;
    if (j < end) {
      const float x = __bfloat162float(t[j]);
      c = STRICT ? x < v : x <= v;
    }
    idx += __popc(__ballot_sync(kFull, c));
  }
  return idx;
}

struct Args {
  const void* U;           // (n, d) rows: bf16 (K4), int8 (K5) or f32
  const float* uscale;     // (n,) K5 only
  const float* uslack;     // (n,)
  const float* Q;          // (B, d)
  const float* qnorm1;     // (B,)
  const __nv_bfloat16* thr;  // (n, tau) K4 only
  const void* tab;         // (n, tau) bf16 (K4) or int8 (K5)
  const float* thr_sc;     // (n,) K5 only, as the next four
  const float* thr_off;
  const float* thr_dev;
  const float* tab_sc;
  const float* tab_off;
  float* r_lo;             // (n, ldo) user-major
  float* r_up;
  float* est;
  int n, d, B, tau, ldo;
  float m_plus_1;
  float c0, c1, c2;        // K4: 1+ε, 1−ε; K5: Δ, pad, ½+pad
  const int* ids;          // the row map (nullptr: identity), K7
  int block_n;             // rows a map entry names
  int rows;                // compact rows to compute (n without a map)
  int qrows;               // rows of Qᵀ in shared memory at once
};

// The global row of compact row r < rows, or n for a row past n
template <bool MASKED>
__device__ __forceinline__ int global_row(const Args& a, int r) {
  if constexpr (!MASKED) return r;
  const int g = a.ids[r / a.block_n] * a.block_n + r % a.block_n;
  return g < a.n ? g : a.n;
}

// Rows [c0, c0 + len) of Qᵀ into shared memory: qs[k - c0][b]
template <int NB>
__device__ __forceinline__ void stage_q(float* qs, const Args& a, int c0,
                                        int len) {
  constexpr int kStride = q_stride<NB>();
  for (int i = threadIdx.x; i < len * NB; i += blockDim.x) {
    const int k = i / NB, b = i % NB;
    qs[k * kStride + b] = b < a.B ? a.Q[(size_t)b * a.d + c0 + k] : 0.f;
  }
}

// acc[b] += u_k·q_bk over this lane's k in [c0, c1), one fmaf each in
// ascending k; qs holds rows c0.. of Qᵀ
template <int NB, typename RowT>
__device__ __forceinline__ void dot_chunk(float (&acc)[NB], const RowT* u,
                                          const float* qs, int c0, int c1,
                                          int lane) {
  constexpr int kStride = q_stride<NB>();
  for (int k0 = c0; k0 < c1; k0 += 32 * kUChunk) {
    float uv[kUChunk];
#pragma unroll
    for (int i = 0; i < kUChunk; ++i) {
      const int k = k0 + lane + 32 * i;
      uv[i] = k < c1 ? to_f32(u[k]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kUChunk; ++i) {
      const int k = k0 + lane + 32 * i;
      if (k < c1) {
        const float* qk = qs + (k - c0) * kStride;
        float qv[NB];
        if constexpr (NB >= 4) {
#pragma unroll
          for (int c = 0; c < NB / 4; ++c) {
            const float4 x = reinterpret_cast<const float4*>(qk)[c];
            qv[4 * c] = x.x;
            qv[4 * c + 1] = x.y;
            qv[4 * c + 2] = x.z;
            qv[4 * c + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int b = 0; b < NB; ++b) qv[b] = qk[b];
        }
#pragma unroll
        for (int b = 0; b < NB; ++b) acc[b] = fmaf(uv[i], qv[b], acc[b]);
      }
    }
  }
}

// query._est_from_grid for one (user, query), in its operation order.
// frac = clip((s − thr_up)/span, 0, 1) divides only inside (0, span):
// outside it the clipped quotient is 0 or 1 exactly, and at the grid's
// edges (span = 1e-12) the quotient would take the division's slow path
__device__ __forceinline__ float est_from_grid(float s, int idx, int tau,
                                               float thr_up, float thr_lo,
                                               float e_lo, float e_hi,
                                               float rlo, float rup,
                                               float m_plus_1) {
  const float ftau = (float)tau;
  const float span = fmaxf(thr_lo - thr_up, 1e-12f);
  const float x = s - thr_up;
  const float frac = x <= 0.f ? 0.f : (x >= span ? 1.f : x / span);
  const bool interior = idx > 0 && idx < tau;
  const float est_in = rup + (rlo - rup) * frac;
  const float rng = fmaxf(e_hi - e_lo, 1e-12f);
  const float m_above = fmaxf(s - e_hi, 0.f) / rng;
  const float m_below = fmaxf(e_lo - s, 0.f) / rng;
  const float est_above = 1.f + (rup - 1.f) / (1.f + ftau * m_above);
  const float est_below =
      m_plus_1 - (m_plus_1 - rlo) * expf(-ftau * m_below);
  float e = interior ? est_in : (idx == tau ? est_above : est_below);
  e = fminf(fmaxf(e, rlo), rup);
  return e - 0.5f * m_above / (1.f + m_above);
}

// K4's lookup for one (user, query), given the two search counts
__device__ __forceinline__ void finish_bf16(const Args& a, int user, size_t o,
                                            float s, int idx_lo, int idx_hi,
                                            const __nv_bfloat16* t,
                                            float e_lo, float e_hi) {
  const int tau = a.tau;
  const __nv_bfloat16* tb =
      static_cast<const __nv_bfloat16*>(a.tab) + (size_t)user * tau;
  const int up_col = min(max(idx_lo - 1, 0), tau - 1);
  const int lo_col = min(idx_hi, tau - 1);
  const float rup =
      idx_lo == 0 ? a.m_plus_1 : __bfloat162float(tb[up_col]) * a.c0;
  const float rlo = idx_hi == tau ? 1.f : __bfloat162float(tb[lo_col]) * a.c1;
  const float thr_up = __bfloat162float(t[min(max(idx_hi - 1, 0), tau - 1)]);
  const float thr_lo = __bfloat162float(t[lo_col]);
  a.r_lo[o] = rlo;
  a.r_up[o] = rup;
  a.est[o] = est_from_grid(s, idx_hi, tau, thr_up, thr_lo, e_lo, e_hi, rlo,
                           rup, a.m_plus_1);
}

// K5's lookup for one (user, query): closed-form bucketize of the score
// s (already times the user's scale) and its slack
__device__ __forceinline__ void finish_int8(const Args& a, int user, size_t o,
                                            float s, float slack, float sc_t,
                                            float off_t, float dev,
                                            float sc_b, float off_b) {
  const int tau = a.tau;
  const float delta = a.c0;
  const float ftau = (float)tau;
  const float s_n = (s - off_t) / sc_t;
  const float d_n = slack / sc_t;
  const float v_hi = (s_n + d_n) + dev;
  const float v_lo = (s_n - d_n) - dev;
  const int c_hi =
      (int)fminf(fmaxf(floorf((v_hi + 127.f) / delta), -1.f), ftau) + 1;
  const int c_lo =
      (int)fminf(fmaxf(floorf((v_lo + 127.f) / delta), -1.f), ftau) + 1;
  const int idx_hi = min(max(c_hi, 0), tau);
  const int idx_lo = min(max(c_lo, 0), tau);
  const int8_t* tb = static_cast<const int8_t*>(a.tab) + (size_t)user * tau;
  const float wid = a.c2 * sc_b;
  const int up_col = min(max(idx_lo - 1, 0), tau - 1);
  const int lo_col = min(idx_hi, tau - 1);
  const float rup = idx_lo == 0 ? a.m_plus_1
                                : ((float)tb[up_col] * sc_b + off_b) + wid;
  const float rlo =
      idx_hi == tau ? 1.f : ((float)tb[lo_col] * sc_b + off_b) - wid;
  const int c_up = min(max(idx_hi - 1, 0), tau - 1);
  const float thr_up = ((float)c_up * delta - 127.f) * sc_t + off_t;
  const float thr_lo = ((float)lo_col * delta - 127.f) * sc_t + off_t;
  a.r_lo[o] = rlo;
  a.r_up[o] = rup;
  a.est[o] = est_from_grid(s, idx_hi, tau, thr_up, thr_lo,
                           -127.f * sc_t + off_t, 127.f * sc_t + off_t, rlo,
                           rup, a.m_plus_1);
}

// At several queries a lane holds much state (sums, K4's staged chunk,
// the batch's results); asking for four resident blocks an SM caps it at
// 64 registers. K4 runs faster so despite a few spills; K5 at 16
// queries, uncapped, took just over 64 and ran a third slower on the
// three blocks an SM that left room for.
//
// STREAM is a.qrows < d and MASKED is a.ids != nullptr, as in K1: only
// then does the loop hold block barriers, or the row map's dependent
// loads and branches.
template <int NB, int KIND, typename RowT, bool STREAM, bool MASKED>
__global__ void __launch_bounds__(kWarps * 32, NB > 1 ? 4 : 1)
quant_bound_ranks_kernel(const Args a) {
  constexpr int kStride = q_stride<NB>();
  constexpr int kShift = 5 - log2_nb<NB>();  // lanes per query: 1 << kShift
  constexpr int kG = 32 / NB;                // users per batch of a warp
  constexpr bool kStage = KIND == kBf16 && NB > 1;
  extern __shared__ __align__(16) float qs[];  // (qrows, stride): qs[k][b]
  const int d = a.d, tau = a.tau;
  float* ts = qs + a.qrows * kStride + (threadIdx.x >> 5) * kTile;
  if constexpr (!STREAM) {
    stage_q<NB>(qs, a, 0, d);
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int my_b = lane >> kShift;         // query of this lane's sums
  const float qn = my_b < a.B ? a.qnorm1[my_b] : 0.f;
  // lane L finishes query L % NB of the batch's user L / NB
  const int fin_b = lane % NB;
  const int fin_g = lane / NB;
  const float fin_qn = fin_b < a.B ? a.qnorm1[fin_b] : 0.f;
  const RowT* U = static_cast<const RowT*>(a.U);

  // a warp takes kG rows at a time. Streamed, every warp of a block runs
  // the same iterations, so that the block can synchronise on each chunk
  // of Qᵀ, and a warp without a row only stages
  for (int b0 = (blockIdx.x * kWarps + (STREAM ? 0 : warp)) * kG;
       b0 < a.rows; b0 += gridDim.x * kWarps * kG) {
    const int base = STREAM ? b0 + warp * kG : b0;
    // the finishing user's per-user values, loaded before any score
    const int fuser =
        MASKED ? min(global_row<MASKED>(a, min(base + fin_g, a.rows - 1)),
                     a.n - 1)
               : min(base + fin_g, a.n - 1);
    const float uslack = a.uslack[fuser];
    float uscale = 1.f, sc_t = 1.f, off_t = 0.f, dev = 0.f, sc_b = 1.f,
          off_b = 0.f, e_lo = 0.f, e_hi = 0.f;
    const __nv_bfloat16* ft = nullptr;
    if constexpr (KIND == kInt8) {
      uscale = a.uscale[fuser];
      sc_t = a.thr_sc[fuser];
      off_t = a.thr_off[fuser];
      dev = a.thr_dev[fuser] + a.c1;
      sc_b = a.tab_sc[fuser];
      off_b = a.tab_off[fuser];
    } else {
      ft = a.thr + (size_t)fuser * tau;
      e_lo = __bfloat162float(ft[0]);
      e_hi = __bfloat162float(ft[tau - 1]);
    }
    float s_fin = 0.f;
    int lo_fin = 0, hi_fin = 0;

    for (int g = 0; g < kG; ++g) {
      const int r = base + g;
      if (!STREAM && r >= a.rows) break;  // the same in every lane
      // the same in every lane; without a map every row is a live user
      const int user = r < a.rows ? global_row<MASKED>(a, r) : a.n;
      const bool live = MASKED ? user < a.n : r < a.rows;
      if (!STREAM && !live) continue;
      const RowT* u = U + (size_t)user * d;
      const __nv_bfloat16* t = nullptr;
      float tv[kStage ? kTChunk : 1];
      if constexpr (kStage) {
        // the first chunk does not depend on the scores: its loads go
        // out now and overlap those of the user row
        t = a.thr + (size_t)user * tau;
        if (live) {
#pragma unroll
          for (int i = 0; i < kTChunk; ++i) {
            const int j = lane + 32 * i;
            tv[i] = j < tau ? __bfloat162float(t[j]) : 0.f;
          }
        }
      }
      float acc[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[b] = 0.f;
      if constexpr (STREAM) {
        for (int c0 = 0; c0 < d; c0 += a.qrows) {
          const int c1 = min(d, c0 + a.qrows);
          __syncthreads();  // every warp is done with the previous chunk
          stage_q<NB>(qs, a, c0, c1 - c0);
          __syncthreads();
          if (live) dot_chunk<NB>(acc, u, qs, c0, c1, lane);
        }
        if (!live) continue;
      } else {
        dot_chunk<NB>(acc, u, qs, 0, d, lane);
      }
      halve<NB, NB, 16>(acc, lane);
      const float s = acc[0];  // u·q_{my_b} over the stored row
      int idx_lo = 0, idx_hi = 0;
      if constexpr (KIND == kBf16) {
        // the user's slack comes from a lane that finishes it
        const float slack = __shfl_sync(kFull, uslack, g * NB) * qn;
        const float s_hi = round_bf16(s + slack);
        const float s_lo = round_bf16(s - slack);
        if constexpr (NB == 1) {
          t = a.thr + (size_t)user * tau;
          idx_hi = count_probed<false>(t, tau, s_hi, lane);
          idx_lo = count_probed<true>(t, tau, s_lo, lane);
        } else {
          // each query has an even number of lanes: even lanes count
          // t <= s_hi, odd lanes t < s_lo, and the query's first lane
          // (even) takes idx_lo from its odd neighbour
          const bool hi_lane = (lane & 1) == 0;
          const float key = hi_lane ? s_hi : s_lo;
          int idx = 0;
          for (int j0 = 0;;) {
            const int len = min(kTile, tau - j0);
            __syncwarp();  // the previous chunk's searches are done
#pragma unroll
            for (int i = 0; i < kTChunk; ++i) ts[lane + 32 * i] = tv[i];
            __syncwarp();
            int pos = 0;
#pragma unroll
            for (int step = kTile; step > 0; step >>= 1) {
              if (pos + step <= len) {
                const float x = ts[pos + step - 1];
                if (hi_lane ? x <= key : x < key) pos += step;
              }
            }
            idx += pos;
            j0 += kTile;
            if (j0 >= tau) break;
#pragma unroll
            for (int i = 0; i < kTChunk; ++i) {
              const int j = j0 + lane + 32 * i;
              tv[i] = j < tau ? __bfloat162float(t[j]) : 0.f;
            }
          }
          idx_hi = idx;
          idx_lo = __shfl_down_sync(kFull, idx, 1);
        }
      }
      // hand the user's results to the lanes that finish it: lane L with
      // L / NB == g takes query L % NB from that query's first lane
      const int src = fin_b << kShift;
      const float sv = __shfl_sync(kFull, s, src);
      if (fin_g == g) s_fin = sv;
      if constexpr (KIND == kBf16) {
        const int hv = __shfl_sync(kFull, idx_hi, src);
        const int lv = __shfl_sync(kFull, idx_lo, src);
        if (fin_g == g) {
          hi_fin = hv;
          lo_fin = lv;
        }
      }
    }

    const int r = base + fin_g;
    if (r < a.rows && fin_b < a.B) {
      const int user = global_row<MASKED>(a, r);
      const size_t o = (size_t)r * a.ldo + fin_b;
      if (MASKED && user == a.n) {
        a.r_lo[o] = a.r_up[o] = a.est[o] = a.m_plus_1 + 1.f;
      } else if constexpr (KIND == kBf16) {
        finish_bf16(a, user, o, s_fin, lo_fin, hi_fin, ft, e_lo, e_hi);
      } else {
        finish_int8(a, user, o, s_fin * uscale, uslack * fin_qn, sc_t,
                    off_t, dev, sc_b, off_b);
      }
    }
  }
}

template <int NB, int KIND, typename RowT>
int launch(const Args& a, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int want = (a.rows + kWarps - 1) / kWarps;
  const int blocks = want < sms * 8 ? want : sms * 8;
  const bool stage = KIND == kBf16 && NB > 1;
  const size_t tiles = stage ? (size_t)kWarps * kTile : 0;
  Args b = a;
  b.qrows = ((size_t)a.d * q_stride<NB>() + tiles) * sizeof(float) <=
                    kSmemDefault
                ? a.d
                : kQChunk;
  const size_t smem = ((size_t)b.qrows * q_stride<NB>() + tiles) *
                      sizeof(float);
  const bool streamed = b.qrows < a.d;
  auto kernel = quant_bound_ranks_kernel<NB, KIND, RowT, false, false>;
  if (streamed)
    kernel = a.ids ? quant_bound_ranks_kernel<NB, KIND, RowT, true, true>
                   : quant_bound_ranks_kernel<NB, KIND, RowT, true, false>;
  else if (a.ids)
    kernel = quant_bound_ranks_kernel<NB, KIND, RowT, false, true>;
  kernel<<<blocks, kWarps * 32, smem, stream>>>(b);
  return (int)cudaGetLastError();
}

template <int KIND, typename RowT>
int dispatch(const Args& a, cudaStream_t st) {
  if (a.B == 1) return launch<1, KIND, RowT>(a, st);
  if (a.B == 2) return launch<2, KIND, RowT>(a, st);
  if (a.B <= 4) return launch<4, KIND, RowT>(a, st);
  if (a.B <= 8) return launch<8, KIND, RowT>(a, st);
  return launch<16, KIND, RowT>(a, st);
}

int check(const Args& a) {
  if (a.rows <= 0 || a.B <= 0) return -1;
  if (a.B > kMaxB || a.tau < 2 || a.n <= 0 || a.d <= 0 ||
      (a.ids && a.block_n <= 0))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// K4's arguments; ids == nullptr is the identity map over n rows
int run_bf16(const void* U, int rows_f32, const float* uslack,
             const float* Q, const float* qnorm1, const void* thr,
             const void* tab, const int* ids, float* r_lo, float* r_up,
             float* est, int n, int d, int B, int tau, int ldo,
             float m_plus_1, float widen_up, float widen_lo, int rows,
             int block_n, void* stream) {
  Args a{};
  a.U = U;
  a.uslack = uslack;
  a.Q = Q;
  a.qnorm1 = qnorm1;
  a.thr = static_cast<const __nv_bfloat16*>(thr);
  a.tab = tab;
  a.r_lo = r_lo;
  a.r_up = r_up;
  a.est = est;
  a.n = n;
  a.d = d;
  a.B = B;
  a.tau = tau;
  a.ldo = ldo;
  a.m_plus_1 = m_plus_1;
  a.c0 = widen_up;
  a.c1 = widen_lo;
  a.ids = ids;
  a.block_n = block_n;
  a.rows = rows;
  const int bad = check(a);
  if (bad) return bad < 0 ? 0 : bad;
  const cudaStream_t st = (cudaStream_t)stream;
  return rows_f32 ? dispatch<kBf16, float>(a, st)
                  : dispatch<kBf16, __nv_bfloat16>(a, st);
}

// K5's arguments; ids == nullptr is the identity map over n rows
int run_int8(const void* U, int rows_f32, const float* uscale,
             const float* uslack, const float* Q, const float* qnorm1,
             const float* thr_sc, const float* thr_off, const float* thr_dev,
             const void* tab, const float* tab_sc, const float* tab_off,
             const int* ids, float* r_lo, float* r_up, float* est, int n,
             int d, int B, int tau, int ldo, float m_plus_1, float delta,
             float dev_pad, float widen_c, int rows, int block_n,
             void* stream) {
  Args a{};
  a.U = U;
  a.uscale = uscale;
  a.uslack = uslack;
  a.Q = Q;
  a.qnorm1 = qnorm1;
  a.tab = tab;
  a.thr_sc = thr_sc;
  a.thr_off = thr_off;
  a.thr_dev = thr_dev;
  a.tab_sc = tab_sc;
  a.tab_off = tab_off;
  a.r_lo = r_lo;
  a.r_up = r_up;
  a.est = est;
  a.n = n;
  a.d = d;
  a.B = B;
  a.tau = tau;
  a.ldo = ldo;
  a.m_plus_1 = m_plus_1;
  a.c0 = delta;
  a.c1 = dev_pad;
  a.c2 = widen_c;
  a.ids = ids;
  a.block_n = block_n;
  a.rows = rows;
  const int bad = check(a);
  if (bad) return bad < 0 ? 0 : bad;
  const cudaStream_t st = (cudaStream_t)stream;
  return rows_f32 ? dispatch<kInt8, float>(a, st)
                  : dispatch<kInt8, int8_t>(a, st);
}

}  // namespace

// Outputs are user-major with row stride ldo: out[user * ldo + b]. rows_f32
// != 0 takes f32 user rows (raw users against a bf16 table: the caller
// passes zero slack).
extern "C" int k4_bound_ranks_bf16(const void* U, int rows_f32,
                                   const float* uslack, const float* Q,
                                   const float* qnorm1, const void* thr,
                                   const void* tab, float* r_lo, float* r_up,
                                   float* est, int n, int d, int B, int tau,
                                   int ldo, float m_plus_1, float widen_up,
                                   float widen_lo, void* stream) {
  return run_bf16(U, rows_f32, uslack, Q, qnorm1, thr, tab, nullptr, r_lo,
                  r_up, est, n, d, B, tau, ldo, m_plus_1, widen_up, widen_lo,
                  n, 1, stream);
}

// rows_f32 != 0 takes f32 user rows (raw users against an int8 table: the
// caller passes unit scale and zero slack).
extern "C" int k5_bound_ranks_int8(
    const void* U, int rows_f32, const float* uscale, const float* uslack,
    const float* Q, const float* qnorm1, const float* thr_sc,
    const float* thr_off, const float* thr_dev, const void* tab,
    const float* tab_sc, const float* tab_off, float* r_lo, float* r_up,
    float* est, int n, int d, int B, int tau, int ldo, float m_plus_1,
    float delta, float dev_pad, float widen_c, void* stream) {
  return run_int8(U, rows_f32, uscale, uslack, Q, qnorm1, thr_sc, thr_off,
                  thr_dev, tab, tab_sc, tab_off, nullptr, r_lo, r_up, est, n,
                  d, B, tau, ldo, m_plus_1, delta, dev_pad, widen_c, n, 1,
                  stream);
}

// K7 at bf16: K4 over the nk tiles of block_n rows named by ids (nk,);
// outputs are compact, (nk·block_n) rows with row stride ldo.
extern "C" int k7_bound_ranks_bf16_masked(
    const void* U, int rows_f32, const float* uslack, const float* Q,
    const float* qnorm1, const void* thr, const void* tab, const int* ids,
    float* r_lo, float* r_up, float* est, int n, int d, int B, int tau,
    int ldo, float m_plus_1, float widen_up, float widen_lo, int nk,
    int block_n, void* stream) {
  return run_bf16(U, rows_f32, uslack, Q, qnorm1, thr, tab, ids, r_lo, r_up,
                  est, n, d, B, tau, ldo, m_plus_1, widen_up, widen_lo,
                  nk * block_n, block_n, stream);
}

// K7 at int8: K5 over the nk tiles of block_n rows named by ids (nk,).
extern "C" int k7_bound_ranks_int8_masked(
    const void* U, int rows_f32, const float* uscale, const float* uslack,
    const float* Q, const float* qnorm1, const float* thr_sc,
    const float* thr_off, const float* thr_dev, const void* tab,
    const float* tab_sc, const float* tab_off, const int* ids, float* r_lo,
    float* r_up, float* est, int n, int d, int B, int tau, int ldo,
    float m_plus_1, float delta, float dev_pad, float widen_c, int nk,
    int block_n, void* stream) {
  return run_int8(U, rows_f32, uscale, uslack, Q, qnorm1, thr_sc, thr_off,
                  thr_dev, tab, tab_sc, tab_off, ids, r_lo, r_up, est, n, d,
                  B, tau, ldo, m_plus_1, delta, dev_pad, widen_c,
                  nk * block_n, block_n, stream);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
