// The step-1 ring kernel, shared by K1/K6 (user_scores.cu) and K4/K5/K7
// (user_scores_quant.cu): u·q for a block of <= 16 queries, the bucketize
// of each score against the user's thresholds row and the table lookup,
// on rows streamed through a shared-memory ring. Each source instantiates
// only its own kinds (kF32 there, kBf16 and kInt8 here), through its own
// resolver handed to run().
//
// A block is eight consumer warps and one producer warp, and the grid is
// persistent (the blocks that fit the SMs at once, each taking every
// gridDim-th tile of T consecutive rows). The producer keeps a ring of S
// stages full: for each tile, one elected lane issues one bulk asynchronous
// copy (cp.async.bulk, the 1-D form of TMA) per array, completing on the
// stage's mbarrier: the rows, the thresholds rows where they ride the ring
// (THR), and the tile's slice of each per-user f32 vector of the quantized
// kinds. The bytes of an array outside its 16-byte-aligned middle go by
// ordinary loads of the producer's lanes; every range lands at its global
// address modulo 16 (ring.cuh, landed_at). Behind a row map (K6, K7) the
// producer reads each tile's map entry once and copies that entry's rows,
// so no row waits on a load of its id. Consumers release a stage on a
// second mbarrier once every warp has taken its rows.
//
// A consumer warp takes rows warp, warp + 8, ... of each tile, two at a
// time at 8 and 16 queries (dot_rows2). Each score is lane l's fmaf chain
// over k = l, l+32, ... from 0.0f, the partial sums reduced by recursive
// halving (step1_common.cuh), so it is bitwise the same at every query
// count, from either place a row is read, and in every layout. A warp
// hands each (row, query) of a batch of 32 / NB rows to its own lane; when
// the batch is full every lane issues its table gathers (and K1's search
// at one query), and the batch finishes after the warp's next score, which
// the gathers overlap. Qᵀ stays whole in shared memory up to 48 KB and
// streams through it in chunks of 256 rows beyond; rows too long for two
// stages of one row each stream through the ring in chunks (CHUNKED), each
// lane keeping its k-set and fmaf order. Ragged n, d, tau and B are masked;
// nothing is padded.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

enum Kind { kBf16 = 0, kInt8 = 1, kF32 = 2 };

// Blocks an SM each instance is built for. The ring hides the loads, so
// what holds a warp back is the latency of its own chain (shared-memory
// loads, shuffles, the lookup's divisions): the more warps, the better.
// At one query a lane holds little (56 registers at four blocks), but
// K1's search needs 70 (at four blocks it spills; at two a block holds
// fewer warps), at two and four queries the sums of every query (72 at
// three), at eight and sixteen those of two rows (112 at two).
__host__ __device__ constexpr int min_blocks(int nb, int kind) {
  return nb == 1 ? (kind == kF32 ? 3 : 4) : rows_at_once(nb) == 2 ? 2 : 3;
}

// A block's shared memory when `blocks` share an SM's 228 KB, each
// with 1 KB the runtime keeps
constexpr size_t share(int blocks) {
  return blocks >= 4 ? 54 * 1024
         : blocks == 3 ? 72 * 1024
         : blocks == 2 ? 110 * 1024 : kBudgetOne;
}

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

// #{t_j <= key} (le) or #{t_j < key} of an ascending bf16 or f32 row, one
// key a lane: a branchless binary search over the whole row
template <typename T>
__device__ __forceinline__ int count_search(const T* t, int tau, float key,
                                            bool le) {
  int pos = 0;
  for (int step = 1 << (31 - __clz(tau)); step > 0; step >>= 1) {
    if (pos + step <= tau) {
      const float x = to_f32(t[pos + step - 1]);
      if (le ? x <= key : x < key) pos += step;
    }
  }
  return pos;
}

// The same on a row in global memory: each 512-value chunk is staged as
// f32 in the warp's scratch ts and searched there
template <typename T>
__device__ __forceinline__ int count_chunked(const T* t, int tau, float key,
                                             bool le, float* ts, int lane) {
  int idx = 0;
  for (int j0 = 0; j0 < tau; j0 += kTile) {
    const int len = min(kTile, tau - j0);
    float tv[kTChunk];
#pragma unroll
    for (int i = 0; i < kTChunk; ++i) {
      const int j = j0 + lane + 32 * i;
      tv[i] = j < tau ? to_f32(t[j]) : 0.f;
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

// K1 at one query: idx = #{j < tau : t_j <= s} of an ascending f32 row in
// global memory, by one lane, with the values the lookup needs: t[0],
// t[tau - 1] and the thresholds around idx, t[idx - 1] and t[idx] (each
// column clamped to [0, tau)). The row lies in ns 32-byte sectors; the
// count is read off whole sectors (two aligned float4 loads each; their
// values outside the row share the sector, so its page, and are masked):
//   1. t[0] and t[tau - 1]: s below the first gives 0, at or above the
//      last tau;
//   2. the grid guess: the build's thresholds are an even grid, so the
//      column c = ⌊(s − t[0]) / (t[tau−1] − t[0]) · (tau − 1)⌋ is about
//      the last one <= s; the sectors of c and c + 1 are read, and where
//      their first value is <= s and their last > s the count is theirs;
//   3. otherwise a bisection of the sectors left finds K, the number of
//      sectors whose first value of the row is <= s (one probe a round:
//      more probes a round, or no guess, read more sectors and were
//      slower), and one read of sector K − 1 counts inside it: the values
//      before it are <= s and those after it > s. t[idx−1] lies in it, and
//      t[idx] too unless idx is the first column of the next sector,
//      which is then read alone.
// A count does not depend on how it is searched on an ascending row, so
// idx is the same whatever the guess; a guess that misses costs reads.
__device__ __forceinline__ int sector_count(const float* t, int tau, float s,
                                            float& e_lo, float& e_hi,
                                            float& thr_up, float& thr_lo) {
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(t);
  const uintptr_t s0 = a0 >> 5;
  const int ns = (int)(((a0 + 4 * (uintptr_t)tau - 1) >> 5) - s0) + 1;
  // column of slot 0 of sector k (negative in a sector the row starts in)
  auto slot0 = [&](int k) {
    return (int)(((long long)((s0 + k) << 5) - (long long)a0) >> 2);
  };
  auto sector_of = [&](int col) {
    return (int)(((a0 + 4 * (uintptr_t)col) >> 5) - s0);
  };
  auto read = [&](int k, float* v) {
    const float4* sec = reinterpret_cast<const float4*>((s0 + k) << 5);
    const float4 x0 = sec[0], x1 = sec[1];
    v[0] = x0.x, v[1] = x0.y, v[2] = x0.z, v[3] = x0.w;
    v[4] = x1.x, v[5] = x1.y, v[6] = x1.z, v[7] = x1.w;
  };
  e_lo = t[0];
  e_hi = t[tau - 1];
  thr_up = thr_lo = e_lo;  // idx = 0: both columns clamp to 0
  if (!(s >= e_lo)) return 0;
  thr_up = thr_lo = e_hi;  // idx = tau: both clamp to tau - 1
  if (s >= e_hi) return tau;
  // t[0] <= s < t[tau - 1]: 0 < idx < tau and 1 <= K <= ns
  int lo = 1, hi = ns;
  {  // the grid guess
    const float g = (s - e_lo) / (e_hi - e_lo) * (float)(tau - 1);
    const int c = g >= 0.f && g < (float)(tau - 1) ? (int)g : 0;
    const int ka = sector_of(c), kb = sector_of(c + 1);
    float v[16];
    read(ka, v);
    if (kb != ka) read(kb, v + 8);
    const int j0 = slot0(ka), nv = kb != ka ? 16 : 8;
    const int jf = max(j0, 0), jl = min(j0 + nv, tau) - 1;  // window's ends
    float first = 0.f, last = 0.f;
    int cnt = 0;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int j = j0 + e;
      if (e >= nv || j < 0 || j >= tau) continue;
      if (j == jf) first = v[e];
      if (j == jl) last = v[e];
      if (v[e] <= s) ++cnt;
    }
    if (first <= s && last > s) {  // the edge lies inside the window
      const int idx = jf + cnt;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        if (e >= nv) continue;
        if (j0 + e == idx - 1) thr_up = v[e];
        if (j0 + e == idx) thr_lo = v[e];
      }
      return idx;
    }
    if (first > s)
      hi = ka;      // sector ka's first value is > s
    else
      lo = kb + 1;  // every value through sector kb is <= s
  }
  while (lo < hi) {  // K > k exactly where sector k's first value <= s
    const int k = (lo + hi) / 2;
    if (t[max(slot0(k), 0)] <= s)
      lo = k + 1;
    else
      hi = k;
  }
  const int j0 = slot0(lo - 1);
  float v[8];
  read(lo - 1, v);
  int idx = max(j0, 0);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (j0 + e >= 0 && j0 + e < tau && v[e] <= s) ++idx;
  bool have_lo = false;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    if (j0 + e == idx - 1) thr_up = v[e];
    if (j0 + e == idx) {
      thr_lo = v[e];
      have_lo = true;
    }
  }
  if (!have_lo) thr_lo = t[idx];
  return idx;
}

// ------------------------------------------------------------ barriers
// The consumer warps only (the producer warp never joins)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// ------------------------------------------------------------- layout
// One block's shared memory: the ring's barriers, Qᵀ (whole or one
// streamed chunk), the per-warp search scratch of K4 (and of K1 at more
// than one query) where the thresholds rows are not staged, then S stages
// of one tile each: a 16-byte header and one region per staged array,
// each 16 bytes longer than T rows.
// Rows too long for two stages of one row each take the chunked layout:
// a tile is kWarps rows, one a consumer warp, and streams through nch
// consecutive stages, each holding kc values of every row (a region of
// rcap bytes a row); the per-user vectors ride the tile's last stage and
// the thresholds rows stay in global memory.
struct Layout {
  int T;       // rows a tile holds
  int S;       // stages of the ring
  int thr;     // thresholds rows staged (1) or searched in place
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
                 int T, int thr, unsigned rows_cap, int tau, int nvec,
                 size_t thr_elem) {
  const unsigned thr_cap =
      thr ? align16((size_t)T * thr_elem * tau) + 16 : 0;
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

// K4's thresholds rows ride the ring where they fit, and K1's at more than
// one query (at one, its sector search reads a few sectors of each row in
// global memory, a fraction of the row); K5 reads none. Where a staged
// kind's rows are not staged and several queries search them, each warp
// stages 512 values at a time in a scratch of its own.
bool plan(Layout& L, int kind, size_t elem, int nb, int d, int tau) {
  const size_t stride = nb >= 8 ? nb + 4 : nb;
  const int qrows = (size_t)d * stride * 4 <= kQWhole ? d : kQChunk;
  const int nvec = kind == kBf16 ? 1 : kind == kInt8 ? 7 : 0;
  const size_t thr_elem = kind == kF32 ? 4 : 2;
  const bool staged = kind == kBf16 || (kind == kF32 && nb > 1);
  const bool scratch = kind != kInt8 && nb > 1;
  const int tiles[] = {64, 32, 16, 8, 4, 2, 1};
  const size_t budgets[] = {share(min_blocks(nb, kind)), share(2),
                            kBudgetOne};
  const size_t q_bytes = align16((size_t)qrows * stride * 4);
  L.qrows = qrows;
  for (const size_t budget : budgets) {
    for (int thr = staged ? 1 : 0; thr >= 0; --thr) {
      const size_t ts_bytes =
          scratch && !thr ? (size_t)kWarps * kTile * 4 : 0;
      const size_t fixed = kBarBytes + q_bytes + ts_bytes;
      for (const int T : tiles) {
        if (T < 8 && budget != kBudgetOne) break;
        const unsigned rows_cap = align16((size_t)T * d * elem) + 16;
        if (!fill_layout(L, budget, fixed, q_bytes, T, thr, rows_cap, tau,
                         nvec, thr_elem))
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
  // stages fit one block an SM; thresholds rows are searched in global
  // memory (the chunked instances are built without THR)
  const size_t ts_bytes = scratch ? (size_t)kWarps * kTile * 4 : 0;
  const size_t fixed = kBarBytes + q_bytes + ts_bytes;
  for (int kc = (d + kQChunk - 1) / kQChunk * kQChunk; kc >= kQChunk;
       kc -= kQChunk) {
    const unsigned rcap = align16((size_t)kc * elem) + 16;
    if (!fill_layout(L, kBudgetOne, fixed, q_bytes, kWarps, 0,
                     kWarps * rcap, tau, nvec, thr_elem))
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
  const float* uslack;     // (n,) K4 and K5
  const float* Q;          // (B, d)
  const float* qnorm1;     // (B,) K4 and K5
  const void* thr;         // (n, tau) bf16 (K4) or f32 (K1); K5 none
  const void* tab;         // (n, tau) bf16 (K4), int8 (K5) or f32 (K1)
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
  const int* n_valid;      // the elastic entries' row count, read on the
                           // device (nullptr: rows); identity map only
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

// The thresholds' element: bf16 (K4) or f32 (K1)
template <int KIND>
using ThrT = std::conditional_t<KIND == kF32, float, __nv_bfloat16>;

// Staged array k (1.. after the rows): its base, bytes per row and
// region in a stage
template <int KIND, bool THR>
__device__ __forceinline__ void staged_array(const Args& a, int k,
                                             const unsigned char*& base,
                                             unsigned& row_bytes,
                                             unsigned& region) {
  constexpr int kV0 = KIND != kInt8 && THR ? 2 : 1;
  if (k < kV0) {
    base = reinterpret_cast<const unsigned char*>(a.thr);
    row_bytes = sizeof(ThrT<KIND>) * a.tau;
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
__device__ __forceinline__ TileHdr tile_of(const Args& a, int t, int rows) {
  TileHdr h;
  if constexpr (!MASKED) {
    h.c0 = h.g0 = t * a.L.T;
    h.cnt = h.live = min(a.L.T, rows - h.c0);
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

// The same for K1, literally as its first kernel (and the plain version)
// wrote it: every quantity computed, the result selected
__device__ __forceinline__ float est_f32(float s, int idx, int tau,
                                         float lo_thr, float hi_thr,
                                         float e_lo, float e_hi, float rlo,
                                         float rup, float m_plus_1) {
  const float ftau = (float)tau;
  const float span = fmaxf(hi_thr - lo_thr, 1e-12f);
  const float frac = fminf(fmaxf((s - lo_thr) / span, 0.f), 1.f);
  const bool interior = idx > 0 && idx < tau;
  const float est_in = rup + (rlo - rup) * frac;
  const float rng = fmaxf(e_hi - e_lo, 1e-12f);
  const float m_above = fmaxf(s - e_hi, 0.f) / rng;
  const float m_below = fmaxf(e_lo - s, 0.f) / rng;
  const float est_above = 1.f + (rup - 1.f) / (1.f + ftau * m_above);
  const float est_below = m_plus_1 - (m_plus_1 - rlo) * expf(-ftau * m_below);
  float e = interior ? est_in : (idx == tau ? est_above : est_below);
  e = fminf(fmaxf(e, rlo), rup);
  return e - 0.5f * m_above / (1.f + m_above);
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
// the row's turn (the score, K4's and K1's counts and thresholds, K5's
// scalars), and the table values it loads when the batch is full
struct Fin {
  int row, user;           // compact row of the outputs, global row
  int j;                   // its row in the current tile until harvested
  int lo, hi;              // idx_lo, idx_hi (K1: both idx)
  float s;                 // the score (K5: times the user's scale)
  float thr_up, thr_lo, e_lo, e_hi;   // K4, K1: thresholds around idx_hi
  float slack, dev;                   // K5: slack, thr_dev + pad
  float sc_t, off_t, sc_b, off_b;     // K5: the row's affines
  __nv_bfloat16 bu, bl;    // K4: T̃[idx_lo − 1], T̃[idx_hi] (clamped)
  int8_t iu, il;           // K5: the same codes
  float fu, fl;            // K1: T[idx − 1], T[idx] (clamped)
};

// A full batch, on every lane at once: K5's bucketize, K1's search at one
// query, then every kind's two table gathers, whose values are first used
// by finish()
template <int KIND, int NB>
__device__ __forceinline__ void prepare(const Args& a, Fin& f) {
  const int tau = a.tau;
  if constexpr (KIND == kF32) {
    if constexpr (NB == 1) {
      const float* t = static_cast<const float*>(a.thr) + (size_t)f.user * tau;
      f.hi = f.lo = sector_count(t, tau, f.s, f.e_lo, f.e_hi, f.thr_up,
                                 f.thr_lo);
    }
    const float* tb = static_cast<const float*>(a.tab) + (size_t)f.user * tau;
    f.fu = tb[min(max(f.lo - 1, 0), tau - 1)];
    f.fl = tb[min(f.hi, tau - 1)];
  } else if constexpr (KIND == kBf16) {
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
  if constexpr (KIND == kF32) {
    const float rup = f.lo == 0 ? a.m_plus_1 : f.fu;
    const float rlo = f.hi == tau ? 1.f : f.fl;
    a.r_lo[o] = rlo;
    a.r_up[o] = rup;
    a.est[o] = est_f32(f.s, f.hi, tau, f.thr_up, f.thr_lo, f.e_lo, f.e_hi,
                       rlo, rup, a.m_plus_1);
  } else if constexpr (KIND == kBf16) {
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
// MASKED is a.ids != nullptr; THR (K4, K1 at more than one query) is
// a.L.thr: the thresholds rows ride the ring, else they are searched in
// global memory; CHUNKED is a.L.nch > 1: rows stream through the ring in
// chunks (never with THR). Whole-row and chunked layouts are separate
// instances, so that a whole-row instance keeps its sums live only while a
// row is summed.
template <int NB, int KIND, typename RowT, bool MASKED, bool THR,
          bool CHUNKED>
__global__ void __launch_bounds__(kThreads, min_blocks(NB, KIND))
step1_ring_kernel(const __grid_constant__ Args a) {
  constexpr int kShift = 5 - log2_nb<NB>();  // lanes per query: 1 << kShift
  constexpr int kG = 32 / NB;                // rows of a warp's batch
  constexpr int kR = rows_at_once(NB);
  constexpr int kVecs = KIND == kBf16 ? 1 : KIND == kInt8 ? 7 : 0;
  constexpr int kArrays = 1 + (KIND != kInt8 && THR ? 1 : 0) + kVecs;
  using TT = ThrT<KIND>;
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
  // An elastic entry reads its row count here, once: its tiles are the
  // ⌈n_valid / T⌉ first of the capacity, each row computed as at any
  // other count, and rows at or past n_valid are neither read nor
  // written (a CUDA graph replays this launch at every count)
  const int rows = a.n_valid ? max(0, min(*a.n_valid, a.rows)) : a.rows;
  const int ntiles = a.n_valid ? (rows + a.L.T - 1) / a.L.T : a.ntiles;
  __syncthreads();

  if (warp == kWarps) {
    // the producer: fill i of this block into stage i % S, a tile taking
    // one fill with whole rows, a.L.nch in the chunked layout
    int i = 0;
    auto produce = [&](int t) {
      const TileHdr h = tile_of<MASKED>(a, t, rows);
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
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) produce(t);
    return;
  }

  const int my_b = lane >> kShift;         // query of this lane's sums
  const float qn = KIND != kF32 && my_b < a.B ? a.qnorm1[my_b] : 0.f;
  // lane L finishes query L % NB of the batch's row L / NB
  const int fin_b = lane % NB;
  const int fin_g = lane / NB;
  const float fin_qn =
      KIND != kF32 && fin_b < a.B ? a.qnorm1[fin_b] : 0.f;
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
      const TT* thr_g = static_cast<const TT*>(a.thr);
      const TT* thr_s = nullptr;
      if constexpr (KIND != kInt8 && THR)
        thr_s = reinterpret_cast<const TT*>(landed_at(
            st + a.L.thr_off, thr_g + (size_t)h.g0 * tau));
      // per-user vector v (vec_ptr's order) of row j
      auto vec = [&](int v, int j) {
        return reinterpret_cast<const float*>(landed_at(
            st + a.L.vec_off + v * a.L.vec_cap, vec_ptr(a, v) + h.g0))[j];
      };
      auto thr_row = [&](int j) {
        return THR ? thr_s + (size_t)j * tau
                   : thr_g + (size_t)(h.g0 + j) * tau;
      };
      // the values of this tile's rows that a batch finishes with, read by
      // every lane that took one of them at once
      auto harvest = [&]() {
        if (f.j < 0) return;
        if constexpr (KIND == kF32) {
          if constexpr (NB > 1) {  // at one query the search reads them
            const float* tr = thr_row(f.j);
            f.e_lo = tr[0];
            f.e_hi = tr[tau - 1];
          }
        } else if constexpr (KIND == kBf16) {
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

      // what follows a row's sums: the halving, K4's searches (K1's at more
      // than one query), and the row's turn in the warp's batch
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
        } else if constexpr (KIND == kF32 && NB > 1) {
          // one key a query: every lane counts its query's t <= s (the
          // lanes of a query alike), and the thresholds around the count
          const float* tr = thr_row(j);
          int idx;
          if constexpr (THR)
            idx = count_search(tr, tau, sc, true);
          else
            idx = count_chunked(tr, tau, sc, true, ts, lane);
          const float tu = tr[min(max(idx - 1, 0), tau - 1)];
          const float tl = tr[min(idx, tau - 1)];
          hv = lv = __shfl_sync(kFull, idx, src);
          tuv = __shfl_sync(kFull, tu, src);
          tlv = __shfl_sync(kFull, tl, src);
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
          prepare<KIND, NB>(a, f);
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
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) consume();
  if (!pending && slot > 0) prepare<KIND, NB>(a, f);
  finish_batch(pending ? kG : slot);
}

// ----------------------------------------------------------------- host
using KernelFn = void (*)(const Args);

template <int KIND, typename RowT, bool MASKED, bool THR, bool CHUNKED>
KernelFn pick_nb(int nb) {
  switch (nb) {
    case 1:
      return step1_ring_kernel<1, KIND, RowT, MASKED, THR, CHUNKED>;
    case 2:
      return step1_ring_kernel<2, KIND, RowT, MASKED, THR, CHUNKED>;
    case 4:
      return step1_ring_kernel<4, KIND, RowT, MASKED, THR, CHUNKED>;
    case 8:
      return step1_ring_kernel<8, KIND, RowT, MASKED, THR, CHUNKED>;
    default:
      return step1_ring_kernel<16, KIND, RowT, MASKED, THR, CHUNKED>;
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

// The instance of a launch, given by each source for its own kinds, so
// that each builds only those
using Resolver = KernelFn (*)(int kind, bool rows_f32, int nb, bool masked,
                              const Layout& L);

int nb_of(int B) { return B == 1 ? 1 : B == 2 ? 2 : B <= 4 ? 4 : B <= 8 ? 8 : 16; }

// Bytes of a row's value: f32 rows (K1, or raw users at K4/K5), else the
// stored type
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

// The least tau of a kind: K4/K5's reference needs two thresholds, K1 one
int min_tau(int kind) { return kind == kF32 ? 1 : 2; }

int check(const Args& a, int kind) {
  if (a.rows <= 0 || a.B <= 0) return -1;
  if (a.B > kMaxB || a.tau < min_tau(kind) || a.n <= 0 || a.d <= 0 ||
      (a.ids && a.block_n <= 0))
    return (int)cudaErrorInvalidValue;
  return 0;
}

int run(Args a, int kind, int rows_f32, Resolver resolve, void* stream) {
  const int bad = check(a, kind);
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

// The launch a call of this kind makes at these sizes, and its kernel's
// resources: out[0..9] = rows a tile, stages, thresholds staged, dynamic
// shared memory in bytes, blocks an SM, registers a thread, local memory
// a thread in bytes (spills), rows of Qᵀ held at once, static shared
// memory in bytes, values of each row a stage holds (d unless rows stream
// in chunks).
int launch_config(int kind, int rows_f32, int B, int d, int tau, int masked,
                  Resolver resolve, int* out) {
  Layout L{};
  if (B < 1 || B > kMaxB || d < 1 || tau < min_tau(kind))
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

}  // namespace
