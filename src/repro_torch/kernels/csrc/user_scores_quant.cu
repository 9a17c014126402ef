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
// Design: rows stream through shared memory in tiles of T consecutive
// users. A block is eight consumer warps and one producer warp, and the
// grid is persistent (the blocks that fit the SMs at once, each taking
// every gridDim-th tile). The producer keeps a ring of S stages full:
// for each tile, one elected lane issues one bulk asynchronous copy
// (cp.async.bulk, the 1-D form of TMA) per array, completing on the
// stage's mbarrier: the stored rows, K4's bf16 thresholds rows, and the
// tile's slice of each per-user f32 vector (K4: slack; K5: scale, slack
// and the five table affines). The bytes of an array that do not fill a
// 16-byte-aligned chunk (a ragged tail, or a start off 16 bytes, as
// under a row map or in a view at any offset) go by ordinary loads of the
// producer's lanes; every range lands at its global address modulo 16,
// so its 16-byte-aligned middle lands aligned, and consumers find it from
// that address (ring.cuh, landed_at). Consumers release a stage on a
// second mbarrier once every warp has taken its rows.
//
// A consumer warp takes rows warp, warp + 8, ... of each tile, two at a
// time at 8 and 16 queries. Each row's score is K1's (step1_common.cuh):
// lane l sums k = l, l+32, ... with one fmaf chain from 0.0f, the partial
// sums reduced by recursive halving, now from the staged row (two rows
// share each Qᵀ value a lane loads, each with its own chain); so a score
// is bitwise the same at every query count and from either place the row
// is read. K4 then searches the staged thresholds row in shared
// memory: for one query by warp-wide probes (16 segment ends, then the
// one segment), for several by a binary search of the whole row on every
// lane, the two searches of a query on two of its lanes. A count does not
// depend on the order of the search, so the indices are those of any
// search. K5's bucketize is arithmetic. The lookup that follows
// (divisions, exp, gathers) is most of the instructions, so it runs on
// every lane: a warp hands each (row, query) of a batch of 32 / NB rows
// to its own lane, the lanes of a tile's rows take their values out of
// the stage together (scalars, edge thresholds), and when the batch is
// full every lane computes K5's bucketize and issues its two table
// gathers; the batch finishes after the warp's next score, which the
// gathers overlap. Ragged n, d, tau and B are masked; nothing is padded.
//
// Qᵀ stays whole in shared memory up to 48 KB and streams through it in
// chunks of 256 rows beyond (d > 614 at 16 queries), the consumer warps
// synchronising between chunks on a named barrier; a chunk is a multiple
// of 32 rows, which keeps each lane's fmaf order and so every score. Each
// instance is built for a number of blocks an SM (min_blocks); the
// launcher picks the largest T (64 down to 8) whose ring of at least two
// stages fits that many, else two, else one; where K4's thresholds rows
// do not fit even so (large tau), they are searched in global memory, 512
// values at a time staged in the warp's scratch.
// Rows longer than two stages of one row each can hold (d past about
// 25,000 at f32, 50,000 at bf16) stream through the ring in chunks: a tile
// is then eight rows, one a consumer warp, and takes nch consecutive
// stages of kc values a row (kc a multiple of 256, as many as two stages
// of one block an SM hold); a warp's sums carry over the chunks, each lane
// keeping its k-set and fmaf order, so every score is the whole-row
// layout's. The per-user vectors ride the tile's last stage, and K4's
// thresholds rows are searched in global memory. Chunked and whole-row
// layouts are separate instances of the kernel.
//
// K7 (k7_bound_ranks_bf16_masked, k7_bound_ranks_int8_masked) is this
// kernel behind K6's row map. It replaces the TPU kernel
// repro/kernels/user_scores.py bound_ranks_batched_quant_masked_kernel_call:
// compact rows [e·block_n, (e+1)·block_n) read global rows from
// ids[e]·block_n on, whose per-row vectors (slack, scales, offsets,
// thr_dev) are read at the same global rows, and a compact row past n is
// written as m + 2 in all three outputs. The producer reads each tile's
// map entry and copies that entry's rows as tiles of T, so no row waits
// on a load of its id. The kept tiles of K7 are bitwise K4's / K5's
// outputs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ring.cuh"
#include "step1_common.cuh"

namespace {

constexpr int kConsumers = kWarps * 32;        // threads that compute
constexpr int kThreads = kConsumers + 32;      // and one producer warp
constexpr int kMaxStages = 4;
constexpr size_t kQWhole = 48 * 1024;          // Qᵀ whole up to this
constexpr size_t kBudgetOne = 220 * 1024;      // a block, one an SM
constexpr unsigned kBarBytes = 2 * kMaxStages * 8;

// Rows a warp sums at once: at 8 and 16 queries a lane reads NB floats
// of Qᵀ from shared memory for every k of a row; two rows share each
// value read, which halves that traffic and gives a lane two independent
// chains
__host__ __device__ constexpr int rows_at_once(int nb) {
  return nb >= 8 ? 2 : 1;
}

// Blocks an SM each instance is built for. The ring hides the loads, so
// what holds a warp back is the latency of its own chain (shared-memory
// loads, shuffles, the lookup's divisions): the more warps, the better.
// At one query a lane holds little (56 registers at four blocks), at two
// and four the sums of every query (72 at three), at eight and sixteen
// those of two rows (112 at two).
__host__ __device__ constexpr int min_blocks(int nb) {
  return nb == 1 ? 4 : rows_at_once(nb) == 2 ? 2 : 3;
}

// A block's shared memory when `blocks` share an SM's 228 KB, each
// with 1 KB the runtime keeps
constexpr size_t share(int blocks) {
  return blocks >= 4 ? 54 * 1024
         : blocks == 3 ? 72 * 1024
         : blocks == 2 ? 110 * 1024 : kBudgetOne;
}

enum Kind { kBf16 = 0, kInt8 = 1 };

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

// #{t_j <= key} (le) or #{t_j < key} of an ascending row, one key a lane:
// a branchless binary search over the whole row
__device__ __forceinline__ int count_search(const __nv_bfloat16* t, int tau,
                                            float key, bool le) {
  int pos = 0;
  for (int step = 1 << (31 - __clz(tau)); step > 0; step >>= 1) {
    if (pos + step <= tau) {
      const float x = __bfloat162float(t[pos + step - 1]);
      if (le ? x <= key : x < key) pos += step;
    }
  }
  return pos;
}

// The same on a row in global memory: each 512-value chunk is staged as
// f32 in the warp's scratch ts and searched there
__device__ __forceinline__ int count_chunked(const __nv_bfloat16* t, int tau,
                                             float key, bool le, float* ts,
                                             int lane) {
  int idx = 0;
  for (int j0 = 0; j0 < tau; j0 += kTile) {
    const int len = min(kTile, tau - j0);
    float tv[kTChunk];
#pragma unroll
    for (int i = 0; i < kTChunk; ++i) {
      const int j = j0 + lane + 32 * i;
      tv[i] = j < tau ? __bfloat162float(t[j]) : 0.f;
    }
    __syncwarp();  // the previous chunk's searches are done
#pragma unroll
    for (int i = 0; i < kTChunk; ++i) ts[lane + 32 * i] = tv[i];
    __syncwarp();
    int pos = 0;
#pragma unroll
    for (int step = kTile; step > 0; step >>= 1) {
      if (pos + step <= len) {
        const float x = ts[pos + step - 1];
        if (le ? x <= key : x < key) pos += step;
      }
    }
    idx += pos;
  }
  return idx;
}

// ------------------------------------------------------------ barriers
// The consumer warps only (the producer warp never joins)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// ------------------------------------------------------------- layout
// One block's shared memory: the ring's barriers, Qᵀ (whole or one
// streamed chunk), K4's per-warp search scratch where its thresholds
// rows are not staged, then S stages of one tile each: a 16-byte header
// and one region per staged array, each 16 bytes longer than T rows.
// Rows too long for two stages of one row each take the chunked layout:
// a tile is kWarps rows, one a consumer warp, and streams through nch
// consecutive stages, each holding kc values of every row (a region of
// rcap bytes a row); the per-user vectors ride the tile's last stage and
// K4's thresholds rows stay in global memory.
struct Layout {
  int T;       // rows a tile holds
  int S;       // stages of the ring
  int thr;     // K4's thresholds rows staged (1) or searched in place
  int qrows;   // rows of Qᵀ in shared memory at once
  int kc;      // values of each row a stage holds (d: whole rows)
  int nch;     // stages a tile takes (1: whole rows)
  unsigned rcap;  // bytes of a row's region in the chunked layout, else 0
  unsigned q_off, ts_off, ring_off, stage_bytes;
  unsigned rows_off, thr_off, vec_off, vec_cap;
  unsigned total;
};

inline unsigned align16(size_t x) {
  return (unsigned)((x + 15) & ~size_t(15));
}

// The rest of the layout once T, thr, the rows' region and the fixed part
// are chosen; false if two stages do not fit the budget
bool fill_layout(Layout& L, size_t budget, size_t fixed, size_t q_bytes,
                 int T, int thr, unsigned rows_cap, int tau, int nvec) {
  const unsigned thr_cap = thr ? align16((size_t)T * 2 * tau) + 16 : 0;
  const unsigned vec_cap = align16(4 * (size_t)T) + 16;
  const size_t stage = 16 + (size_t)rows_cap + thr_cap + (size_t)nvec * vec_cap;
  if (fixed + 2 * stage > budget) return false;
  L.T = T;
  L.S = (int)((budget - fixed) / stage);
  if (L.S > kMaxStages) L.S = kMaxStages;
  L.thr = thr;
  L.q_off = kBarBytes;
  L.ts_off = (unsigned)(kBarBytes + q_bytes);
  L.ring_off = (unsigned)fixed;
  L.stage_bytes = (unsigned)stage;
  L.rows_off = 16;
  L.thr_off = 16 + rows_cap;
  L.vec_off = 16 + rows_cap + thr_cap;
  L.vec_cap = vec_cap;
  L.total = (unsigned)(fixed + L.S * stage);
  return true;
}

bool plan(Layout& L, int kind, size_t elem, int nb, int d, int tau) {
  const size_t stride = nb >= 8 ? nb + 4 : nb;
  const int qrows = (size_t)d * stride * 4 <= kQWhole ? d : kQChunk;
  const int nvec = kind == kBf16 ? 1 : 7;
  const int tiles[] = {64, 32, 16, 8, 4, 2, 1};
  const size_t budgets[] = {share(min_blocks(nb)), share(2), kBudgetOne};
  const size_t q_bytes = align16((size_t)qrows * stride * 4);
  L.qrows = qrows;
  for (const size_t budget : budgets) {
    for (int thr = kind == kBf16 ? 1 : 0; thr >= 0; --thr) {
      const size_t ts_bytes =
          kind == kBf16 && !thr && nb > 1 ? (size_t)kWarps * kTile * 4 : 0;
      const size_t fixed = kBarBytes + q_bytes + ts_bytes;
      for (const int T : tiles) {
        if (T < 8 && budget != kBudgetOne) break;
        const unsigned rows_cap = align16((size_t)T * d * elem) + 16;
        if (!fill_layout(L, budget, fixed, q_bytes, T, thr, rows_cap, tau,
                         nvec))
          continue;
        L.kc = d;
        L.nch = 1;
        L.rcap = 0;
        return true;
      }
    }
  }
  // the chunked layout: the largest chunk, a multiple of kQChunk values
  // (so of 32: each lane keeps its k-set and fmaf order), of which two
  // stages fit one block an SM; K4's thresholds rows are searched in
  // global memory (its chunked instances are built without THR)
  const size_t ts_bytes =
      kind == kBf16 && nb > 1 ? (size_t)kWarps * kTile * 4 : 0;
  const size_t fixed = kBarBytes + q_bytes + ts_bytes;
  for (int kc = (d + kQChunk - 1) / kQChunk * kQChunk; kc >= kQChunk;
       kc -= kQChunk) {
    const unsigned rcap = align16((size_t)kc * elem) + 16;
    if (!fill_layout(L, kBudgetOne, fixed, q_bytes, kWarps, 0,
                     kWarps * rcap, tau, nvec))
      continue;
    L.kc = kc;
    L.nch = (d + kc - 1) / kc;
    L.rcap = rcap;
    return true;
  }
  return false;
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
  int ntiles;              // tiles of the launch
  int tpe;                 // tiles a map entry spans (K7)
  Layout L;
};

// Per-user vector v of the staged order: slack first (K4 stages only it)
__device__ __forceinline__ const float* vec_ptr(const Args& a, int v) {
  switch (v) {
    case 0: return a.uslack;
    case 1: return a.uscale;
    case 2: return a.thr_sc;
    case 3: return a.thr_off;
    case 4: return a.thr_dev;
    case 5: return a.tab_sc;
    default: return a.tab_off;
  }
}

// Staged array k (1.. after the rows): its base, bytes per row and
// region in a stage
template <int KIND, bool THR>
__device__ __forceinline__ void staged_array(const Args& a, int k,
                                             const unsigned char*& base,
                                             unsigned& row_bytes,
                                             unsigned& region) {
  constexpr int kV0 = KIND == kBf16 && THR ? 2 : 1;
  if (k < kV0) {
    base = reinterpret_cast<const unsigned char*>(a.thr);
    row_bytes = 2 * a.tau;
    region = a.L.thr_off;
  } else {
    base = reinterpret_cast<const unsigned char*>(vec_ptr(a, k - kV0));
    row_bytes = 4;
    region = a.L.vec_off + (k - kV0) * a.L.vec_cap;
  }
}

// Piece p of the rows a stage of a tile (global rows g0.., `live` of them)
// holds, for values [k0, k1) of each row: whole rows are one piece (the
// tile's rows, contiguous); the chunked layout copies each live row's
// chunk into its own region. Every piece lands at its global address
// modulo 16 (copy_edges), whatever the base of U.
template <typename RowT, bool CHUNKED>
__device__ __forceinline__ void row_piece(const Args& a, int g0, int live,
                                          int p, int k0, int k1,
                                          const unsigned char*& src,
                                          unsigned& len, unsigned& region) {
  const size_t row = (size_t)a.d * sizeof(RowT);
  const unsigned char* U = static_cast<const unsigned char*>(a.U);
  if constexpr (!CHUNKED) {
    src = U + (size_t)g0 * row;
    len = (unsigned)(live * row);
    region = a.L.rows_off;
  } else {
    src = U + (size_t)(g0 + p) * row + (size_t)k0 * sizeof(RowT);
    len = (unsigned)((k1 - k0) * sizeof(RowT));
    region = a.L.rows_off + p * a.L.rcap;
  }
}

// A tile: compact rows [c0, c0 + cnt), read from global rows g0.. of
// which the first `live` lie below n (live < cnt only past n under K7)
struct TileHdr {
  int c0, cnt, g0, live;
};

template <bool MASKED>
__device__ __forceinline__ TileHdr tile_of(const Args& a, int t) {
  TileHdr h;
  if constexpr (!MASKED) {
    h.c0 = h.g0 = t * a.L.T;
    h.cnt = h.live = min(a.L.T, a.rows - h.c0);
  } else {
    const int e = t / a.tpe;
    const int j = (t - e * a.tpe) * a.L.T;
    h.c0 = e * a.block_n + j;
    h.cnt = min(a.L.T, a.block_n - j);
    h.g0 = a.ids[e] * a.block_n + j;
    h.live = max(0, min(h.cnt, a.n - h.g0));
  }
  return h;
}

// ------------------------------------------------------------- lookup
// query._est_from_grid for one (user, query), each value by the same
// expression in the same operation order. Only what the result selects
// is computed: frac = clip((s − thr_up)/span, 0, 1) divides only inside
// (0, span), where outside it the clipped quotient is 0 or 1 exactly (and
// at the grid's edges, span = 1e-12, would take the division's slow
// path); m_above = max(s − e_hi, 0)/rng and m_below divide only where
// their numerator is positive, being +0 elsewhere; the estimates above
// and below the grid are computed only where idx selects them; and the
// final tie-break subtracts 0.5·m_above/(1 + m_above), which is +0 unless
// s > e_hi (e >= 1, so e − 0 = e). Most (user, query) pairs lie inside
// the grid and skip four divisions and the exp.
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
  const float rng = fmaxf(e_hi - e_lo, 1e-12f);
  const float m_above = s > e_hi ? (s - e_hi) / rng : 0.f;
  float e;
  if (interior) {
    e = rup + (rlo - rup) * frac;
  } else if (idx == tau) {
    e = 1.f + (rup - 1.f) / (1.f + ftau * m_above);
  } else {
    const float m_below = e_lo > s ? (e_lo - s) / rng : 0.f;
    e = m_plus_1 - (m_plus_1 - rlo) * expf(-ftau * m_below);
  }
  e = fminf(fmaxf(e, rlo), rup);
  return s > e_hi ? e - 0.5f * m_above / (1.f + m_above) : e;
}

// K5's closed-form bucketize of the score s (already times the user's
// scale) and its slack
__device__ __forceinline__ void int8_indices(float s, float slack, float sc_t,
                                             float off_t, float dev,
                                             float delta, int tau,
                                             int& idx_lo, int& idx_hi) {
  const float ftau = (float)tau;
  const float s_n = (s - off_t) / sc_t;
  const float d_n = slack / sc_t;
  const float v_hi = (s_n + d_n) + dev;
  const float v_lo = (s_n - d_n) - dev;
  const int c_hi =
      (int)fminf(fmaxf(floorf((v_hi + 127.f) / delta), -1.f), ftau) + 1;
  const int c_lo =
      (int)fminf(fmaxf(floorf((v_lo + 127.f) / delta), -1.f), ftau) + 1;
  idx_hi = min(max(c_hi, 0), tau);
  idx_lo = min(max(c_lo, 0), tau);
}

// What the lane that finishes a (row, query) takes out of the stage at
// the row's turn (the score, K4's counts and thresholds, K5's scalars),
// and the table values it loads when the batch is full
struct Fin {
  int row, user;           // compact row of the outputs, global row
  int j;                   // its row in the current tile until harvested
  int lo, hi;              // idx_lo, idx_hi
  float s;                 // the score (K5: times the user's scale)
  float thr_up, thr_lo, e_lo, e_hi;   // K4: thresholds around idx_hi
  float slack, dev;                   // K5: slack, thr_dev + pad
  float sc_t, off_t, sc_b, off_b;     // K5: the row's affines
  __nv_bfloat16 bu, bl;    // K4: T̃[idx_lo − 1], T̃[idx_hi] (clamped)
  int8_t iu, il;           // K5: the same codes
};

// A full batch, on every lane at once: K5's bucketize, then both kinds'
// two table gathers, whose values are first used by finish()
template <int KIND>
__device__ __forceinline__ void prepare(const Args& a, Fin& f) {
  const int tau = a.tau;
  if constexpr (KIND == kBf16) {
    const __nv_bfloat16* tb =
        static_cast<const __nv_bfloat16*>(a.tab) + (size_t)f.user * tau;
    f.bu = tb[min(max(f.lo - 1, 0), tau - 1)];
    f.bl = tb[min(f.hi, tau - 1)];
  } else {
    int8_indices(f.s, f.slack, f.sc_t, f.off_t, f.dev, a.c0, tau, f.lo,
                 f.hi);
    const int8_t* tb = static_cast<const int8_t*>(a.tab) + (size_t)f.user * tau;
    f.iu = tb[min(max(f.lo - 1, 0), tau - 1)];
    f.il = tb[min(f.hi, tau - 1)];
  }
}

template <int KIND>
__device__ __forceinline__ void finish(const Args& a, const Fin& f, int b) {
  const int tau = a.tau;
  const size_t o = (size_t)f.row * a.ldo + b;
  if constexpr (KIND == kBf16) {
    const float rup = f.lo == 0 ? a.m_plus_1 : __bfloat162float(f.bu) * a.c0;
    const float rlo = f.hi == tau ? 1.f : __bfloat162float(f.bl) * a.c1;
    a.r_lo[o] = rlo;
    a.r_up[o] = rup;
    a.est[o] = est_from_grid(f.s, f.hi, tau, f.thr_up, f.thr_lo, f.e_lo,
                             f.e_hi, rlo, rup, a.m_plus_1);
  } else {
    const float delta = a.c0;
    const float wid = a.c2 * f.sc_b;
    const float rup = f.lo == 0 ? a.m_plus_1
                                : ((float)f.iu * f.sc_b + f.off_b) + wid;
    const float rlo =
        f.hi == tau ? 1.f : ((float)f.il * f.sc_b + f.off_b) - wid;
    const int c_up = min(max(f.hi - 1, 0), tau - 1);
    const int lo_col = min(f.hi, tau - 1);
    const float thr_up = ((float)c_up * delta - 127.f) * f.sc_t + f.off_t;
    const float thr_lo = ((float)lo_col * delta - 127.f) * f.sc_t + f.off_t;
    a.r_lo[o] = rlo;
    a.r_up[o] = rup;
    a.est[o] = est_from_grid(f.s, f.hi, tau, thr_up, thr_lo,
                             -127.f * f.sc_t + f.off_t,
                             127.f * f.sc_t + f.off_t, rlo, rup, a.m_plus_1);
  }
}

// dot_chunk over two rows at once: each Qᵀ value loaded feeds both rows'
// fmaf chains, each of which runs as dot_chunk's (its k ascending, from
// its own 0.0f), so each row's sums are bitwise dot_chunk's
template <int NB, typename RowT>
__device__ __forceinline__ void dot_rows2(float (&acc0)[NB],
                                          float (&acc1)[NB],
                                          const RowT* __restrict__ u0,
                                          const RowT* __restrict__ u1,
                                          const float* qs, int c0, int c1,
                                          int lane) {
  constexpr int kStride = q_stride<NB>();
  constexpr int kU = kUChunk / 2;
  for (int k0 = c0; k0 < c1; k0 += 32 * kU) {
    float uv0[kU], uv1[kU];
#pragma unroll
    for (int i = 0; i < kU; ++i) {
      const int k = k0 + lane + 32 * i;
      uv0[i] = k < c1 ? to_f32(u0[k]) : 0.f;
      uv1[i] = k < c1 ? to_f32(u1[k]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kU; ++i) {
      const int k = k0 + lane + 32 * i;
      if (k < c1) {
        const float4* qk =
            reinterpret_cast<const float4*>(qs + (k - c0) * kStride);
#pragma unroll
        for (int c = 0; c < NB / 4; ++c) {
          const float4 x = qk[c];
          const float qv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc0[4 * c + e] = fmaf(uv0[i], qv[e], acc0[4 * c + e]);
            acc1[4 * c + e] = fmaf(uv1[i], qv[e], acc1[4 * c + e]);
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------- kernel
// MASKED is a.ids != nullptr; THR (K4) is a.L.thr: the thresholds rows
// ride the ring, else they are searched in global memory; CHUNKED is
// a.L.nch > 1: rows stream through the ring in chunks (never with THR).
// Whole-row and chunked layouts are separate instances, so that a
// whole-row instance keeps its sums live only while a row is summed.
template <int NB, int KIND, typename RowT, bool MASKED, bool THR,
          bool CHUNKED>
__global__ void __launch_bounds__(kThreads, min_blocks(NB))
quant_bound_ranks_kernel(const __grid_constant__ Args a) {
  constexpr int kShift = 5 - log2_nb<NB>();  // lanes per query: 1 << kShift
  constexpr int kG = 32 / NB;                // rows of a warp's batch
  constexpr int kR = rows_at_once(NB);
  constexpr int kVecs = KIND == kBf16 ? 1 : 7;
  constexpr int kArrays = 1 + (KIND == kBf16 && THR ? 1 : 0) + kVecs;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  float* qs = reinterpret_cast<float*>(smem + a.L.q_off);  // qs[k][b]
  unsigned char* ring = smem + a.L.ring_off;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int d = a.d, tau = a.tau, S = a.L.S;
  const bool stream = a.L.qrows < d;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (!stream) stage_q<NB>(qs, a.Q, a.B, d, 0, d);
  __syncthreads();

  if (warp == kWarps) {
    // the producer: fill i of this block into stage i % S, a tile taking
    // one fill with whole rows, a.L.nch in the chunked layout
    int i = 0;
    auto produce = [&](int t) {
      const TileHdr h = tile_of<MASKED>(a, t);
      const int stages = CHUNKED ? a.L.nch : 1;
      const int pieces = CHUNKED ? h.live : 1;
      for (int c = 0; c < stages; ++c, ++i) {
        const int s = i % S;
        const int k0 = CHUNKED ? c * a.L.kc : 0;
        const int k1 = CHUNKED ? min(d, k0 + a.L.kc) : d;
        const bool last = c == stages - 1;  // the rows' other arrays ride it
        mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
        unsigned char* st = ring + (size_t)s * a.L.stage_bytes;
        if (lane == 0) *reinterpret_cast<TileHdr*>(st) = h;
        unsigned tx = 0;
        for (int p = 0; p < pieces; ++p) {
          const unsigned char* src;
          unsigned len, region;
          row_piece<RowT, CHUNKED>(a, h.g0, h.live, p, k0, k1, src, len,
                                    region);
          tx += copy_edges(st + region, src, len, lane);
        }
        if (last) {
#pragma unroll
          for (int k = 1; k < kArrays; ++k) {
            const unsigned char* base;
            unsigned rb, region;
            staged_array<KIND, THR>(a, k, base, rb, region);
            tx += copy_edges(st + region, base + (size_t)h.g0 * rb,
                             h.live * rb, lane);
          }
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], tx);
          for (int p = 0; p < pieces; ++p) {
            const unsigned char* src;
            unsigned len, region;
            row_piece<RowT, CHUNKED>(a, h.g0, h.live, p, k0, k1, src, len,
                                      region);
            copy_bulk(st + region, src, len, &full[s]);
          }
          if (last) {
#pragma unroll
            for (int k = 1; k < kArrays; ++k) {
              const unsigned char* base;
              unsigned rb, region;
              staged_array<KIND, THR>(a, k, base, rb, region);
              copy_bulk(st + region, base + (size_t)h.g0 * rb, h.live * rb,
                        &full[s]);
            }
          }
        } else {
          mbar_arrive(&full[s]);
        }
      }
    };
    for (int t = blockIdx.x; t < a.ntiles; t += gridDim.x) produce(t);
    return;
  }

  const int my_b = lane >> kShift;         // query of this lane's sums
  const float qn = my_b < a.B ? a.qnorm1[my_b] : 0.f;
  // lane L finishes query L % NB of the batch's row L / NB
  const int fin_b = lane % NB;
  const int fin_g = lane / NB;
  const float fin_qn = fin_b < a.B ? a.qnorm1[fin_b] : 0.f;
  float* ts = reinterpret_cast<float*>(smem + a.L.ts_off) + warp * kTile;
  const int iters = (a.L.T + kWarps - 1) / kWarps;
  Fin f{};
  f.j = -1;
  int slot = 0;          // the batch's next row, the same in every lane
  bool pending = false;  // a prepared batch waits for its finish
  auto finish_batch = [&](int count) {
    if (fin_g < count && fin_b < a.B) finish<KIND>(a, f, fin_b);
  };

  const RowT* U = static_cast<const RowT*>(a.U);
  int i = 0;  // fills taken, one a stage
  // One tile, its stages in turn. The whole-row layout is one stage a tile
  // and sums each row from 0.0f while it is taken; the chunked layout
  // carries a warp's one row's sums over the tile's stages.
  auto consume = [&]() {
    const int stages = CHUNKED ? a.L.nch : 1;
    float sums[kR][NB];
    for (int c = 0; c < stages; ++c, ++i) {
      const int s = i % S;
      mbar_wait(&full[s], (i / S) & 1);
      const int k0 = CHUNKED ? c * a.L.kc : 0;
      const int k1 = CHUNKED ? min(d, k0 + a.L.kc) : d;
      const bool last = c == stages - 1;
      const unsigned char* st = ring + (size_t)s * a.L.stage_bytes;
      const TileHdr h = *reinterpret_cast<const TileHdr*>(st);
      // row j of the tile, indexed by k: every staged range begins at its
      // global address modulo 16 in its region (copy_edges)
      auto row_at = [&](int j) {
        if constexpr (CHUNKED)
          return reinterpret_cast<const RowT*>(landed_at(
                     st + a.L.rows_off + j * a.L.rcap,
                     U + (size_t)(h.g0 + j) * d + k0)) - k0;
        else
          return reinterpret_cast<const RowT*>(landed_at(
                     st + a.L.rows_off, U + (size_t)h.g0 * d)) + (size_t)j * d;
      };
      const __nv_bfloat16* thr_s = nullptr;
      if constexpr (KIND == kBf16 && THR)
        thr_s = reinterpret_cast<const __nv_bfloat16*>(landed_at(
            st + a.L.thr_off, a.thr + (size_t)h.g0 * tau));
      // per-user vector v (vec_ptr's order) of row j
      auto vec = [&](int v, int j) {
        return reinterpret_cast<const float*>(landed_at(
            st + a.L.vec_off + v * a.L.vec_cap, vec_ptr(a, v) + h.g0))[j];
      };
      auto thr_row = [&](int j) {
        return THR ? thr_s + (size_t)j * tau
                   : a.thr + (size_t)(h.g0 + j) * tau;
      };
      // the values of this tile's rows that a batch finishes with, read by
      // every lane that took one of them at once
      auto harvest = [&]() {
        if (f.j < 0) return;
        if constexpr (KIND == kBf16) {
          const __nv_bfloat16* tr = thr_row(f.j);
          f.e_lo = __bfloat162float(tr[0]);
          f.e_hi = __bfloat162float(tr[tau - 1]);
        } else {
          f.s = f.s * vec(1, f.j);
          f.slack = vec(0, f.j) * fin_qn;
          f.sc_t = vec(2, f.j);
          f.off_t = vec(3, f.j);
          f.dev = vec(4, f.j) + a.c1;
          f.sc_b = vec(5, f.j);
          f.off_b = vec(6, f.j);
        }
        f.j = -1;
      };

      // what follows a row's sums: the halving, K4's searches, and the
      // row's turn in the warp's batch
      auto row_step = [&](int j, float (&acc)[NB]) {
        halve<NB, NB, 16>(acc, lane);
        const float sc = acc[0];  // u·q_{my_b} over the stored row
        // the first lane of query fin_b holds its values (every lane at NB 1)
        const int src = fin_b << kShift;
        const float sv = NB == 1 ? sc : __shfl_sync(kFull, sc, src);
        int hv = 0, lv = 0;
        float tuv = 0.f, tlv = 0.f;
        if constexpr (KIND == kBf16) {
          const __nv_bfloat16* tr = thr_row(j);
          const float slack = vec(0, j) * qn;
          const float s_hi = round_bf16(sc + slack);
          const float s_lo = round_bf16(sc - slack);
          int idx_hi, idx_lo;
          if constexpr (NB == 1) {
            idx_hi = count_probed<false>(tr, tau, s_hi, lane);
            idx_lo = count_probed<true>(tr, tau, s_lo, lane);
          } else {
            // each query has an even number of lanes: even lanes count
            // t <= s_hi, odd lanes t < s_lo, and the query's first lane
            // (even) takes idx_lo from its odd neighbour
            const bool hi_lane = (lane & 1) == 0;
            const float key = hi_lane ? s_hi : s_lo;
            int idx;
            if constexpr (THR)
              idx = count_search(tr, tau, key, hi_lane);
            else
              idx = count_chunked(tr, tau, key, hi_lane, ts, lane);
            idx_hi = idx;
            idx_lo = __shfl_down_sync(kFull, idx, 1);
          }
          // the thresholds around idx_hi, read where the counts are
          const float tu =
              __bfloat162float(tr[min(max(idx_hi - 1, 0), tau - 1)]);
          const float tl = __bfloat162float(tr[min(idx_hi, tau - 1)]);
          if constexpr (NB == 1) {
            hv = idx_hi;
            lv = idx_lo;
            tuv = tu;
            tlv = tl;
          } else {
            hv = __shfl_sync(kFull, idx_hi, src);
            lv = __shfl_sync(kFull, idx_lo, src);
            tuv = __shfl_sync(kFull, tu, src);
            tlv = __shfl_sync(kFull, tl, src);
          }
        }
        // the previous batch finishes before its lanes take this row
        if (pending) {
          finish_batch(kG);
          pending = false;
        }
        if (fin_g == slot) {
          f.row = h.c0 + j;
          f.user = h.g0 + j;
          f.j = j;
          f.s = sv;
          f.hi = hv;
          f.lo = lv;
          f.thr_up = tuv;
          f.thr_lo = tlv;
        }
        if (++slot == kG) {
          slot = 0;
          harvest();
          prepare<KIND>(a, f);
          pending = true;
        }
      };

      // every warp runs the same iterations, so that a streamed Qᵀ can
      // synchronise the consumers; a warp without a row only stages. A
      // warp takes kR rows at once, which share each Qᵀ value it loads. In
      // the chunked layout a tile is one row a warp (iters = 1), whose sums
      // carry over the tile's stages.
      for (int it = 0; it < iters; it += kR) {
        int jr[kR];
        bool live[kR];  // the same in every lane; live[1] implies live[0]
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          jr[r] = warp + (it + r) * kWarps;
          live[r] = it + r < iters && jr[r] < h.live;
          if (MASKED && last && !live[r] && it + r < iters && jr[r] < h.cnt &&
              lane < a.B) {  // past n: m + 2
            const size_t o = (size_t)(h.c0 + jr[r]) * a.ldo + lane;
            a.r_lo[o] = a.r_up[o] = a.est[o] = a.m_plus_1 + 1.f;
          }
        }
        if (c == 0) {
#pragma unroll
          for (int r = 0; r < kR; ++r)
#pragma unroll
            for (int b = 0; b < NB; ++b) sums[r][b] = 0.f;
        }
        // values [q0, q1) of the rows; qk holds rows q0.. of Qᵀ
        auto dot = [&](int q0, int q1, const float* qk) {
          const RowT* u0 = row_at(jr[0]);
          if constexpr (kR == 2) {
            if (live[1]) {
              dot_rows2<NB>(sums[0], sums[1], u0, row_at(jr[1]), qk, q0, q1,
                            lane);
              return;
            }
          }
          if (live[0]) dot_chunk<NB>(sums[0], u0, qk, q0, q1, lane);
        };
        if (stream) {
          for (int q0 = k0; q0 < k1; q0 += a.L.qrows) {
            const int q1 = min(k1, q0 + a.L.qrows);
            consumer_sync();  // every warp is done with the previous chunk
            stage_q<NB>(qs, a.Q, a.B, d, q0, q1 - q0, threadIdx.x,
                        kConsumers);
            consumer_sync();
            dot(q0, q1, qs);
          }
        } else {
          dot(k0, k1, qs + (size_t)k0 * q_stride<NB>());
        }
        if (last) {
#pragma unroll
          for (int r = 0; r < kR; ++r)
            if (live[r]) row_step(jr[r], sums[r]);
        }
      }
      if (last) harvest();
      mbar_arrive(&empty[s]);
    }
  };
  for (int t = blockIdx.x; t < a.ntiles; t += gridDim.x) consume();
  if (!pending && slot > 0) prepare<KIND>(a, f);
  finish_batch(pending ? kG : slot);
}

// ----------------------------------------------------------------- host
using KernelFn = void (*)(const Args);

template <int KIND, typename RowT, bool MASKED, bool THR, bool CHUNKED>
KernelFn pick_nb(int nb) {
  switch (nb) {
    case 1:
      return quant_bound_ranks_kernel<1, KIND, RowT, MASKED, THR, CHUNKED>;
    case 2:
      return quant_bound_ranks_kernel<2, KIND, RowT, MASKED, THR, CHUNKED>;
    case 4:
      return quant_bound_ranks_kernel<4, KIND, RowT, MASKED, THR, CHUNKED>;
    case 8:
      return quant_bound_ranks_kernel<8, KIND, RowT, MASKED, THR, CHUNKED>;
    default:
      return quant_bound_ranks_kernel<16, KIND, RowT, MASKED, THR, CHUNKED>;
  }
}

template <int KIND, typename RowT, bool MASKED>
KernelFn pick_layout(int nb, const Layout& L) {
  if (L.nch > 1) return pick_nb<KIND, RowT, MASKED, false, true>(nb);
  if constexpr (KIND == kBf16) {
    if (L.thr) return pick_nb<KIND, RowT, MASKED, true, false>(nb);
  }
  return pick_nb<KIND, RowT, MASKED, false, false>(nb);
}

template <int KIND, typename RowT>
KernelFn pick(int nb, bool masked, const Layout& L) {
  return masked ? pick_layout<KIND, RowT, true>(nb, L)
                : pick_layout<KIND, RowT, false>(nb, L);
}

KernelFn resolve(int kind, bool rows_f32, int nb, bool masked,
                 const Layout& L) {
  if (kind == kBf16)
    return rows_f32 ? pick<kBf16, float>(nb, masked, L)
                    : pick<kBf16, __nv_bfloat16>(nb, masked, L);
  return rows_f32 ? pick<kInt8, float>(nb, masked, L)
                  : pick<kInt8, int8_t>(nb, masked, L);
}

int nb_of(int B) { return B == 1 ? 1 : B == 2 ? 2 : B <= 4 ? 4 : B <= 8 ? 8 : 16; }

size_t elem_of(int kind, bool rows_f32) {
  return rows_f32 ? 4 : kind == kBf16 ? 2 : 1;
}

// Blocks of `fn` an SM at `smem` bytes; remembered per (kernel, bytes).
// A kernel's dynamic shared-memory limit is raised once, on its first
// use, to the largest ring any plan asks for (a limit set per launch
// would hold a later, larger launch back).
int occupancy(KernelFn fn, unsigned smem, int* err) {
  struct Seen {
    KernelFn fn;
    unsigned smem;
    int blocks;
  };
  static Seen seen[128];
  static int n_seen = 0;
  bool known = false;
  for (int i = 0; i < n_seen; ++i) {
    if (seen[i].fn != fn) continue;
    if (seen[i].smem == smem) return seen[i].blocks;
    known = true;
  }
  cudaError_t e = cudaSuccess;
  if (!known)
    e = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kBudgetOne);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, reinterpret_cast<const void*>(fn), kThreads, smem);
  if (e != cudaSuccess) {
    *err = (int)e;
    return 0;
  }
  if (n_seen < 128) seen[n_seen++] = Seen{fn, smem, blocks};
  return blocks;
}

int check(const Args& a) {
  if (a.rows <= 0 || a.B <= 0) return -1;
  if (a.B > kMaxB || a.tau < 2 || a.n <= 0 || a.d <= 0 ||
      (a.ids && a.block_n <= 0))
    return (int)cudaErrorInvalidValue;
  return 0;
}

int run(Args a, int kind, int rows_f32, void* stream) {
  const int bad = check(a);
  if (bad) return bad < 0 ? 0 : bad;
  const int nb = nb_of(a.B);
  if (!plan(a.L, kind, elem_of(kind, rows_f32), nb, a.d, a.tau))
    return (int)cudaErrorInvalidValue;
  if (a.ids) {
    a.tpe = (a.block_n + a.L.T - 1) / a.L.T;
    a.ntiles = a.rows / a.block_n * a.tpe;
  } else {
    a.ntiles = (a.rows + a.L.T - 1) / a.L.T;
  }
  const KernelFn fn = resolve(kind, rows_f32, nb, a.ids != nullptr, a.L);
  int err = 0;
  const int occ = occupancy(fn, a.L.total, &err);
  if (err) return err;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int blocks = a.ntiles < sms * occ ? a.ntiles : sms * occ;
  fn<<<blocks, kThreads, a.L.total, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
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
  return run(a, kBf16, rows_f32, stream);
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
  return run(a, kInt8, rows_f32, stream);
}

}  // namespace

// Outputs are user-major with row stride ldo: out[user * ldo + b]. rows_f32
// != 0 takes f32 user rows (raw users against a bf16 table: the caller
// passes zero slack). The arrays may start at any address and d may be
// any length.
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

// The launch a K4 (kind 0) or K5 (kind 1) call at these sizes makes, and
// its kernel's resources: out[0..9] = rows a tile, stages, thresholds
// staged (K4), dynamic shared memory in bytes, blocks an SM, registers a
// thread, local memory a thread in bytes (spills), rows of Qᵀ held at
// once, static shared memory in bytes, values of each row a stage holds
// (d unless rows stream in chunks).
extern "C" int quant_launch_config(int kind, int rows_f32, int B, int d,
                                   int tau, int masked, int* out) {
  Layout L{};
  if (B < 1 || B > kMaxB || d < 1 || tau < 2 || (kind != kBf16 && kind != kInt8))
    return (int)cudaErrorInvalidValue;
  const int nb = nb_of(B);
  if (!plan(L, kind, elem_of(kind, rows_f32), nb, d, tau))
    return (int)cudaErrorInvalidValue;
  const KernelFn fn = resolve(kind, rows_f32, nb, masked != 0, L);
  int err = 0;
  const int occ = occupancy(fn, L.total, &err);
  if (err) return err;
  cudaFuncAttributes fa{};
  const cudaError_t e =
      cudaFuncGetAttributes(&fa, reinterpret_cast<const void*>(fn));
  if (e != cudaSuccess) return (int)e;
  out[0] = L.T;
  out[1] = L.S;
  out[2] = L.thr;
  out[3] = (int)L.total;
  out[4] = occ;
  out[5] = fa.numRegs;
  out[6] = (int)fa.localSizeBytes;
  out[7] = L.qrows;
  out[8] = (int)fa.sharedSizeBytes;
  out[9] = L.kc;
  return 0;
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
