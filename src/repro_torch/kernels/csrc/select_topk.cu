// The selection: steps 2-3 of §4.3 (core/query.py select_topk) over step
// 1's bounds, in two stages of two launches each.
//
// Replaces no TPU kernel. The reference leaves these steps to XLA's top_k
// and sort (repro/core/query.py select_topk). On the card the library
// route took 30-37x the bound below. It ran torch.topk, a full stable
// radix sort of every key and `where`s, plus the copies that make step 1's
// user-major (n, B) outputs query-major for them.
//
// Per query b of B over n users, with r_lo, r_up, est (B, n) f32 views
// read through their strides:
//   select.kth     R_lo_k, R_up_k: the k-th smallest r_lo and r_up, as
//                  values (torch.topk's order: -0 below +0, NaN last);
//   select.lemma1  key = guaranteed ? est : prio * (m + 2) + est, with prio
//                  0 where accepted (r_up <= c * R_lo_k), 2 where pruned
//                  (r_lo > R_up_k), else 1, each operation rounded apart
//                  (__fmul_rn, __fadd_rn) as PyTorch's elementwise kernels
//                  round them; indices: the users of the k smallest keys in
//                  ascending order, ties to the lower user (the stable
//                  sort's order: -0 equal to +0, NaN last); est_rank: est
//                  at those users; guaranteed = c * R_lo_k >= R_up_k;
//                  n_accepted, n_pruned: the two masks' counts.
//
// Bound on the card: bytes. Each stage reads r_lo and r_up, and lemma1
// also est: 5 * n * B * 4 bytes, 0.046 ms at Netflix (n = 480,189, B =
// 16) and 0.134 ms at Amazon-Kindle (n = 1,406,890) at 3.35 TB/s. The
// rest is a few kB.
//
// Design. A value becomes a 64-bit pair: its 32-bit order key << 32, or'd
// with its user. Pairs are unique in a row, so "the k smallest" is one
// set, and no tie rule is needed past the user. A warp keeps a row's k
// smallest pairs (k <= 64) as a sorted list over its lanes, two
// registers a lane, and holds the k-th as a threshold. A value above the
// threshold's value cannot enter: one float compare and one vote reject 32
// at once. The few that pass are compared as pairs and go in one at a
// time by shuffles.
//   A block of 512 threads stages a tile of 4,096 elements of each array
// in shared memory. It loads 16 bytes at a time along the contiguous
// axis: the query axis of step 1's user-major buffers, the user axis of a
// query-major tensor, scalar loads at unaligned or ragged edges. Then
// each worker warp scans its query's row of the tile from shared memory.
// Blocks walk contiguous runs of tiles; there are as many blocks as fit on
// the card at once. Each warp's list goes to scratch. A merge launch (one
// block a row) runs the same lists over the candidates of all blocks and
// writes the answer. The lemma1 pass computes the key and the two masks
// as it stages a tile, so its warps scan one array, and counts the masks
// by ballots. A k above 64 runs in rounds of 64: each round takes the
// smallest pairs above the pair the round before ended on. Nothing reads
// a value back to the host: c and m may be 0-d device tensors, read when
// the kernels run, so a CUDA graph can hold the launches.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 512;              // a block of the scan
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 16;                 // queries a block holds
constexpr int kTile = 4096;                // elements of an array a tile
constexpr int kTileCap = kTile + kGroup;   // with the padded pitch
constexpr int kList = 64;                  // pairs a warp's list holds
constexpr int kMergeThreads = 256;
constexpr int kMergeWarps = kMergeThreads / 32;
constexpr int kMergeBatch = 8;             // loads in flight a lane
constexpr unsigned kFull = 0xffffffffu;
constexpr u64 kNone = ~0ull;               // above every pair

struct View {
  const float* p;
  long long sb, su;                        // query and user strides
};

struct Lemma1 {
  float cR, Ru;                            // c * R_lo_k, R_up_k
  bool g;                                  // guaranteed
};

// Everything a launch reads and writes; both kernels of a stage take it.
struct Pass {
  View v[3];                               // r_lo, r_up, est
  int B, n, k;
  int K, off, last;                        // this round: pairs, first
                                           // answer slot, is the last
  int tu, S, G, L, tiles, along_q;         // the plan (plan_of)
  u64* floor;                              // (rows,) the pair the round
  int floored;                             // before ended on
  u64* cand;                               // (rows, L, K)
  int* counts;                             // (B, L, 2), lemma1 round 0
  const float* R;                          // (2, B) R_lo_k, R_up_k
  const float* c_ptr;                      // or c_val
  float c_val;
  const float* m_ptr;                      // or big_val = m + 2
  float big_val;
  float* R_out;                            // kth
  long long* indices;                      // lemma1 (B, k)
  float* est_rank;                         // (B, k)
  unsigned char* guaranteed;               // (B,)
  int* n_out;                              // (2, B) n_accepted, n_pruned
};

__device__ __forceinline__ float at(const View& v, int b, uint32_t u) {
  return v.p[(long long)b * v.sb + (long long)u * v.su];
}

// torch.topk's order on the card: -0 below +0, NaN above everything
__device__ __forceinline__ uint32_t radix_key(float v) {
  const uint32_t x = __float_as_uint(v);
  if (isnan(v)) return 0xffffffffu;
  return x ^ ((x & 0x80000000u) ? 0xffffffffu : 0x80000000u);
}

// the stable sort's order: -0 equal to +0, NaN above everything
__device__ __forceinline__ uint32_t sort_key(float v) {
  uint32_t x = __float_as_uint(v);
  if (isnan(v)) return 0xffffffffu;
  if ((x << 1) == 0u) x = 0u;
  return x ^ ((x & 0x80000000u) ? 0xffffffffu : 0x80000000u);
}

// The value of a pair's order key (either order's), NaN for kNone: no
// value above it orders below the pair.
__device__ __forceinline__ float value_of(u64 pair) {
  const uint32_t k = (uint32_t)(pair >> 32);
  return __uint_as_float((k & 0x80000000u) ? k ^ 0x80000000u : ~k);
}

__device__ __forceinline__ u64 pair_of(uint32_t key, uint32_t u) {
  return ((u64)key << 32) | u;
}

// A warp's sorted list: slot `lane` in a, slot `lane + 32` in b.
struct List {
  u64 a, b;
};

__device__ __forceinline__ u64 list_slot(const List& l, int s) {
  return __shfl_sync(kFull, s < 32 ? l.a : l.b, s & 31);
}

__device__ __forceinline__ void list_insert(List& l, u64 y, int lane) {
  const u64 pa = __shfl_up_sync(kFull, l.a, 1);
  const u64 pb_up = __shfl_up_sync(kFull, l.b, 1);
  const u64 a31 = __shfl_sync(kFull, l.a, 31);
  const u64 pb = lane == 0 ? a31 : pb_up;
  const u64 na = l.a < y ? l.a : (lane == 0 || pa < y ? y : pa);
  const u64 nb = l.b < y ? l.b : (pb < y ? y : pb);
  l.a = na;
  l.b = nb;
}

// Offer each lane's x (kNone for none) to the list of the K smallest;
// thr is its K-th slot (kNone while it holds fewer).
__device__ __forceinline__ void list_offer(List& l, u64& thr, u64 x, int K,
                                           int lane) {
  unsigned m = __ballot_sync(kFull, x < thr);
  while (m) {
    const int j = __ffs(m) - 1;
    list_insert(l, __shfl_sync(kFull, x, j), lane);
    thr = list_slot(l, K - 1);
    m &= m - 1u;
    m &= __ballot_sync(kFull, x < thr);
  }
}

__device__ __forceinline__ Lemma1 lemma1_of(const Pass& a, int b) {
  const float c = a.c_ptr ? *a.c_ptr : a.c_val;
  const float cR = __fmul_rn(c, a.R[b]);
  const float Ru = a.R[a.B + b];
  return {cR, Ru, cR >= Ru};
}

// Up to 4 consecutive elements from (b, u) along the fast axis; one
// 16-byte load where that axis is contiguous, the address aligned and all
// 4 in range.
__device__ __forceinline__ void load4(const View& v, int b, int u,
                                      bool along_q, int cnt, float (&x)[4]) {
  const float* p = v.p + (long long)b * v.sb + (long long)u * v.su;
  const long long step = along_q ? v.sb : v.su;
  if (cnt == 4 && step == 1 && (reinterpret_cast<uintptr_t>(p) & 15u) == 0) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    x[0] = f.x;
    x[1] = f.y;
    x[2] = f.z;
    x[3] = f.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = i < cnt ? p[i * step] : 0.0f;
  }
}

// Stage the tile of users [u0, u0 + nu) of the block's queries [q0, q0 +
// QG): element (b, u) at b * pitch + u of each array (kth: r_lo, r_up;
// lemma1: the key, and its masks in `flags`).
template <int STAGE>
__device__ __forceinline__ void stage_tile(const Pass& a,
                                           float (*tile)[kTileCap],
                                           unsigned char* flags,
                                           const Lemma1* lem, float big,
                                           int q0, int QG, int u0, int nu,
                                           int pitch) {
  const bool along_q = a.along_q;
  const int width = along_q ? QG : nu;      // of a line along the fast axis
  const int per = (width + 3) / 4;
  const int quads = per * (along_q ? nu : QG);
  const int ds = along_q ? pitch : 1;
  for (int v = threadIdx.x; v < quads; v += kThreads) {
    const int line = v / per, f = (v - line * per) * 4;
    const int b = along_q ? f : line, u = along_q ? line : f;
    const int cnt = min(4, width - f);
    const int s0 = b * pitch + u;
    if constexpr (STAGE == 1) {
      float x[4], y[4];
      load4(a.v[0], q0 + b, u0 + u, along_q, cnt, x);
      load4(a.v[1], q0 + b, u0 + u, along_q, cnt, y);
      if (!along_q && cnt == 4) {
        *reinterpret_cast<float4*>(&tile[0][s0]) =
            make_float4(x[0], x[1], x[2], x[3]);
        *reinterpret_cast<float4*>(&tile[1][s0]) =
            make_float4(y[0], y[1], y[2], y[3]);
      } else {
        for (int i = 0; i < cnt; ++i) {
          tile[0][s0 + i * ds] = x[i];
          tile[1][s0 + i * ds] = y[i];
        }
      }
    } else {
      float lo[4], up[4], e[4];
      load4(a.v[0], q0 + b, u0 + u, along_q, cnt, lo);
      load4(a.v[1], q0 + b, u0 + u, along_q, cnt, up);
      load4(a.v[2], q0 + b, u0 + u, along_q, cnt, e);
      for (int i = 0; i < cnt; ++i) {
        const Lemma1 L = lem[along_q ? b + i : b];
        const bool acc = up[i] <= L.cR;            // Lemma 1 (1)
        const bool prn = lo[i] > L.Ru;             // Lemma 1 (2)
        const float prio = acc ? 0.0f : (prn ? 2.0f : 1.0f);
        tile[0][s0 + i * ds] =
            L.g ? e[i] : __fadd_rn(__fmul_rn(prio, big), e[i]);
        flags[s0 + i * ds] = (unsigned char)((acc ? 1 : 0) | (prn ? 2 : 0));
      }
    }
  }
}

// One round of a stage over a run of tiles: block (x, y) takes queries
// [16y, 16y + 16) and tiles [x * tiles / G, (x + 1) * tiles / G). Warp w
// < QG * S scans query w % QG, slice w / QG of each tile (kth: r_lo and
// r_up, two lists), and writes its list(s) to cand.
template <int STAGE>
__global__ void __launch_bounds__(kThreads, 2)
select_scan_kernel(const Pass a) {
  __shared__ __align__(16) float tile[STAGE == 1 ? 2 : 1][kTileCap];
  __shared__ unsigned char flags[STAGE == 1 ? 4 : kTileCap];
  __shared__ Lemma1 lem[kGroup];
  __shared__ float s_big;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.y * kGroup;
  const int QG = min(kGroup, a.B - q0);
  const int pitch = a.along_q ? a.tu + 1 : a.tu;
  const int t0 = (int)((long long)blockIdx.x * a.tiles / a.G);
  const int t1 = (int)((long long)(blockIdx.x + 1) * a.tiles / a.G);
  const bool worker = warp < QG * a.S;
  const int wq = warp % QG, ws = warp / QG;
  const int row = (q0 + wq) * (STAGE == 1 ? 2 : 1);
  const bool counting = STAGE == 2 && a.counts != nullptr;

  u64 floor0 = 0, floor1 = 0;
  if (worker && a.floored) {
    floor0 = a.floor[row];
    if (STAGE == 1) floor1 = a.floor[row + 1];
  }
  if constexpr (STAGE == 2) {
    if (tid < QG) lem[tid] = lemma1_of(a, q0 + tid);
    if (tid == 0) s_big = a.m_ptr ? __fadd_rn(*a.m_ptr, 2.0f) : a.big_val;
  }
  List l0 = {kNone, kNone}, l1 = {kNone, kNone};
  u64 thr0 = kNone, thr1 = kNone;
  float lim0 = value_of(kNone), lim1 = value_of(kNone);  // their values
  int n_acc = 0, n_prn = 0;

  for (int t = t0; t < t1; ++t) {
    const int u0 = t * a.tu;
    const int nu = min(a.tu, a.n - u0);
    __syncthreads();                        // the last tile is scanned
    stage_tile<STAGE>(a, tile, flags, lem, s_big, q0, QG, u0, nu, pitch);
    __syncthreads();
    if (!worker) continue;
    for (int base = ws * 32; base < nu; base += a.S * 32) {
      const int ul = base + lane;
      const bool in = ul < nu;
      const uint32_t u = (uint32_t)(u0 + ul);
      const int s = wq * pitch + ul;
      if constexpr (STAGE == 1) {
        const float y0 = in ? tile[0][s] : 0.0f;
        const float y1 = in ? tile[1][s] : 0.0f;
        // one float compare rejects a value above the threshold's (NaN
        // passes on to the pairs' compare)
        const bool p0 = in && !(y0 > lim0), p1 = in && !(y1 > lim1);
        if (__any_sync(kFull, p0)) {
          u64 x0 = p0 ? pair_of(radix_key(y0), u) : kNone;
          if (a.floored && x0 <= floor0) x0 = kNone;
          list_offer(l0, thr0, x0, a.K, lane);
          lim0 = value_of(thr0);
        }
        if (__any_sync(kFull, p1)) {
          u64 x1 = p1 ? pair_of(radix_key(y1), u) : kNone;
          if (a.floored && x1 <= floor1) x1 = kNone;
          list_offer(l1, thr1, x1, a.K, lane);
          lim1 = value_of(thr1);
        }
      } else {
        if (counting) {
          const unsigned f = in ? flags[s] : 0u;
          n_acc += __popc(__ballot_sync(kFull, f & 1u));
          n_prn += __popc(__ballot_sync(kFull, f & 2u));
        }
        const float y = in ? tile[0][s] : 0.0f;
        const bool p = in && !(y > lim0);
        if (__any_sync(kFull, p)) {
          u64 x = p ? pair_of(sort_key(y), u) : kNone;
          if (a.floored && x <= floor0) x = kNone;
          list_offer(l0, thr0, x, a.K, lane);
          lim0 = value_of(thr0);
        }
      }
    }
  }
  if (!worker) return;
  const int list = blockIdx.x * a.S + ws;
  u64* out = a.cand + ((long long)row * a.L + list) * a.K;
  if (lane < a.K) out[lane] = l0.a;
  if (lane + 32 < a.K) out[lane + 32] = l0.b;
  if constexpr (STAGE == 1) {
    out += (long long)a.L * a.K;            // row + 1
    if (lane < a.K) out[lane] = l1.a;
    if (lane + 32 < a.K) out[lane + 32] = l1.b;
  }
  if (counting && lane == 0) {
    int* c = a.counts + ((long long)(q0 + wq) * a.L + list) * 2;
    c[0] = n_acc;
    c[1] = n_prn;
  }
}

// The round's K smallest of a row's L lists (block = row): each warp
// merges a share of the candidates, then warp 0 merges the warps' lists
// and writes the round's answer (kth: R at the last round; lemma1: the
// answer's slots, and in round 0 the counts and guaranteed).
template <int STAGE>
__global__ void __launch_bounds__(kMergeThreads)
select_merge_kernel(const Pass a) {
  __shared__ u64 part[kMergeWarps * kList];
  __shared__ int sums[kMergeWarps][2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x;
  const int K = a.K;
  const long long total = (long long)a.L * K;
  const u64* cand = a.cand + (long long)row * total;
  List l = {kNone, kNone};
  u64 thr = kNone;
  for (long long base = (long long)warp * 32; base < total;
       base += kMergeBatch * kMergeThreads) {
    u64 x[kMergeBatch];
#pragma unroll
    for (int j = 0; j < kMergeBatch; ++j) {
      const long long i = base + j * kMergeThreads + lane;
      x[j] = i < total ? cand[i] : kNone;
    }
#pragma unroll
    for (int j = 0; j < kMergeBatch; ++j) list_offer(l, thr, x[j], K, lane);
  }
  if (lane < K) part[warp * K + lane] = l.a;
  if (lane + 32 < K) part[warp * K + lane + 32] = l.b;
  const bool counting = STAGE == 2 && a.counts != nullptr;
  if (counting) {
    int acc = 0, prn = 0;
    for (int j = tid; j < a.L; j += kMergeThreads) {
      const int* c = a.counts + ((long long)row * a.L + j) * 2;
      acc += c[0];
      prn += c[1];
    }
    acc = __reduce_add_sync(kFull, acc);
    prn = __reduce_add_sync(kFull, prn);
    if (lane == 0) {
      sums[warp][0] = acc;
      sums[warp][1] = prn;
    }
  }
  __syncthreads();
  if (warp != 0) return;
  l = {kNone, kNone};
  thr = kNone;
  for (int base = 0; base < kMergeWarps * K; base += 32) {
    const int i = base + lane;
    list_offer(l, thr, i < kMergeWarps * K ? part[i] : kNone, K, lane);
  }
  const u64 last = list_slot(l, K - 1);
  if (lane == 0) a.floor[row] = last;
  if constexpr (STAGE == 1) {
    if (a.last && lane == 0) {
      const int b = row >> 1, which = row & 1;
      a.R_out[which * a.B + b] = at(a.v[which], b, (uint32_t)last);
    }
  } else {
    const int b = row;
    for (int s = lane; s < K; s += 32) {
      const uint32_t u = (uint32_t)(s < 32 ? l.a : l.b);
      const long long o = (long long)b * a.k + a.off + s;
      a.indices[o] = (long long)u;
      a.est_rank[o] = at(a.v[2], b, u);
    }
    if (counting && lane == 0) {
      int acc = 0, prn = 0;
      for (int w = 0; w < kMergeWarps; ++w) {
        acc += sums[w][0];
        prn += sums[w][1];
      }
      a.n_out[b] = acc;
      a.n_out[a.B + b] = prn;
      a.guaranteed[b] = lemma1_of(a, b).g ? 1 : 0;
    }
  }
}

struct Plan {
  int tu, S, tiles, NQ;
};

// Users a tile (4,096 elements over the block's queries, rounded to a
// power of two), warps a query, tiles, query groups.
Plan plan_of(int B, int n) {
  const int QG = B < kGroup ? B : kGroup;
  int qgp = 1;
  while (qgp < QG) qgp <<= 1;
  Plan p;
  p.tu = kTile / qgp;
  p.S = kWarps / QG;
  p.tiles = (n + p.tu - 1) / p.tu;
  p.NQ = (B + kGroup - 1) / kGroup;
  return p;
}

bool valid(int B, int n, int k, int G) {
  return B >= 1 && n >= 1 && k >= 1 && k <= n && G >= 1;
}

Pass pass_of(int B, int n, int k, int G, const View& lo, const View& up,
             const View& est, void* scratch) {
  const Plan p = plan_of(B, n);
  Pass a = {};
  a.v[0] = lo;
  a.v[1] = up;
  a.v[2] = est;
  a.B = B;
  a.n = n;
  a.k = k;
  a.tu = p.tu;
  a.S = p.S;
  a.G = G < p.tiles ? G : p.tiles;
  a.L = a.G * p.S;
  a.tiles = p.tiles;
  // 16-byte loads along the queries where users are not contiguous
  a.along_q = lo.sb == 1 && lo.su != 1;
  const int K = k < kList ? k : kList;
  a.floor = reinterpret_cast<u64*>(scratch);
  a.cand = a.floor + 2 * (long long)B;
  a.counts = reinterpret_cast<int*>(a.cand + 2LL * B * a.L * K);
  return a;
}

long long scratch_bytes(int B, int G, int S, int k) {
  const long long L = (long long)G * S;
  const int K = k < kList ? k : kList;
  return 16LL * B + 16LL * B * L * K + 8LL * B * L;
}

}  // namespace

// The plan of a selection of k over (B, n): out[0] = G, the blocks along
// the users of each query group (as many as fit on the card at once, at
// most one a tile); out[1] = the scratch bytes both stages take.
extern "C" int select_plan(int B, int n, int k, long long* out) {
  if (!valid(B, n, k, 1)) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, occ1 = 0, occ2 = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ1, select_scan_kernel<1>, kThreads, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ2, select_scan_kernel<2>, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  const Plan p = plan_of(B, n);
  const int occ = occ1 < occ2 ? occ1 : occ2;
  long long want = ((long long)sms * (occ > 1 ? occ : 1) + p.NQ - 1) / p.NQ;
  if (want > p.tiles) want = p.tiles;
  const int G = (int)(want > 1 ? want : 1);
  out[0] = G;
  out[1] = scratch_bytes(B, G, p.S, k);
  return 0;
}

// select.kth: R (2, B) = the k-th smallest r_lo and r_up of each query.
extern "C" int select_kth(const float* lo, long long lo_sb, long long lo_su,
                          const float* up, long long up_sb, long long up_su,
                          int B, int n, int k, int G, float* R,
                          void* scratch, void* stream) {
  if (!valid(B, n, k, G) || (reinterpret_cast<uintptr_t>(scratch) & 15u))
    return (int)cudaErrorInvalidValue;
  Pass a = pass_of(B, n, k, G, View{lo, lo_sb, lo_su},
                   View{up, up_sb, up_su}, View{lo, lo_sb, lo_su}, scratch);
  a.R_out = R;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid(a.G, (B + kGroup - 1) / kGroup);
  const int rounds = (k + kList - 1) / kList;
  for (int r = 0; r < rounds; ++r) {
    a.K = k - r * kList < kList ? k - r * kList : kList;
    a.off = r * kList;
    a.last = r == rounds - 1;
    a.floored = r > 0;
    select_scan_kernel<1><<<grid, kThreads, 0, s>>>(a);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    select_merge_kernel<1><<<2 * B, kMergeThreads, 0, s>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// select.lemma1: the key and masks against R (select_kth's), the k
// smallest keys' users (B, k) int64 ascending and est there (B, k),
// guaranteed (B,) as bytes, n_out (2, B) int32 = n_accepted, n_pruned. c
// is *c_ptr where c_ptr is not null, else c_val; the class offset m + 2
// is *m_ptr + 2 where m_ptr is not null, else big_val.
extern "C" int select_lemma1(const float* lo, long long lo_sb,
                             long long lo_su, const float* up,
                             long long up_sb, long long up_su,
                             const float* est, long long est_sb,
                             long long est_su, int B, int n, int k, int G,
                             const float* R, const float* c_ptr, float c_val,
                             const float* m_ptr, float big_val,
                             long long* indices, float* est_rank,
                             unsigned char* guaranteed, int* n_out,
                             void* scratch, void* stream) {
  if (!valid(B, n, k, G) || (reinterpret_cast<uintptr_t>(scratch) & 15u))
    return (int)cudaErrorInvalidValue;
  Pass a = pass_of(B, n, k, G, View{lo, lo_sb, lo_su},
                   View{up, up_sb, up_su}, View{est, est_sb, est_su},
                   scratch);
  a.R = R;
  a.c_ptr = c_ptr;
  a.c_val = c_val;
  a.m_ptr = m_ptr;
  a.big_val = big_val;
  a.indices = indices;
  a.est_rank = est_rank;
  a.guaranteed = guaranteed;
  a.n_out = n_out;
  int* counts = a.counts;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid(a.G, (B + kGroup - 1) / kGroup);
  const int rounds = (k + kList - 1) / kList;
  for (int r = 0; r < rounds; ++r) {
    a.K = k - r * kList < kList ? k - r * kList : kList;
    a.off = r * kList;
    a.last = r == rounds - 1;
    a.floored = r > 0;
    a.counts = r == 0 ? counts : nullptr;
    select_scan_kernel<2><<<grid, kThreads, 0, s>>>(a);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    select_merge_kernel<2><<<B, kMergeThreads, 0, s>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
