// K2: Eq. (1) of Algorithm 1 — the rank-table rows of the build.
//
// Replaces the TPU kernel repro/kernels/table_build.py
// (_table_build_kernel / table_build_kernel_call):
//
//   T[i, j] = 1 + sum_s w_s * I[u_i·p_s > t_ij]      (strict >)
//
// for users U (n, d), samples P (S, d), weights w (S,) and thresholds
// (n, tau), all f32. A row of thresholds may hold its values in any order.
//
// Bound on the card: operations, the 2·n·S·d FLOP of the IEEE-f32
// product U·Pᵀ (1.835 ms at Netflix size at 67 TFLOP/s), against about
// 2.3 GB of bytes (U, the thresholds and the table once, 0.7 ms). The
// count by direct comparison takes n·tau·S compare-and-add steps, several
// times the product's time at Netflix size; so the count takes the plain
// version's form (ref.py estimate_table_rows): sort a user's scores,
// suffix-sum the weights, and find each threshold's place by binary
// search, O(S log² S + tau log S) steps a user instead of tau·S.
//
// Design. A call is one pack launch (the samples laid out stage by stage
// of K3's ring, pack.cuh), then, for each chunk of users, two launches:
//   - the product, on K3's tiling (pack.cuh): 128 users x 256 samples a
//     block, an 8 x 16 register tile a thread, the packed samples through
//     a ring of stages filled by one bulk copy each; a tile of at most 128
//     samples (the last at S = 640) computes only the columns it has. It
//     writes the chunk's (users, S) scores into a workspace: one wave of
//     blocks, 43 MB at S = 640, small enough to stay in the 50 MB L2;
//   - the count, one warp a user, 24 warps an SM. The samples go in runs
//     of at most kRun = 992; a run is cut into parts of 32·E samples, E a
//     power of two from the bits of the run's length in warps (640 = 512
//     + 128), E <= 16, so that a lane's keys and weights stay in 32
//     registers. The warp sorts each part by a bitonic network in
//     registers (E keys a lane; each merge opens with its mirror stage, so
//     every exchange ascends; pairs E or more positions apart cross lanes
//     by shuffles) and keeps the sorted keys in shared memory. Where the
//     part's weights are all equal (the stratified samples' |P_l|/s, one
//     value a partition; all of Netflix's) the keys sort alone and a
//     threshold's sum is (samples above it) x weight; otherwise each
//     weight sorts with its key, and the suffix sums of the sorted weights
//     (each lane over its E, then a scan across the lanes) wait beside the
//     keys. Then each lane takes the thresholds j = lane, lane + 32, ...,
//     four at a time (the next four's loads in flight), finds
//     idx = #{score <= t_j} in each part by binary search and adds up the
//     parts' sums. A run past the first adds to the partial sums it finds
//     in the output row, as the parent's runs did.
// The scores never form an (n, S) tensor in device memory; the workspace
// (packed samples, then one chunk of scores) is the wrapper's allocation
// (k2_plan).
//
// The contract. Every score is one fmaf chain over k ascending from 0.0f,
// as in the parent and in K3 (a float4 along k feeds four chained fmaf;
// zero padding past d adds +0 at the end), so every indicator is the
// parent's. Keys compare as floats: -0.0 equals +0.0, and a score equal
// to a threshold does not count. A NaN score never counts and a NaN
// threshold counts nothing, as under the parent's '>'. Where every
// partial sum of the weights is exact in f32 (equal dyadic weights, as
// Netflix's 1777/64 with every sum a multiple of 1/64 below 2^18, or
// small integers), the table is bitwise the parent's. Otherwise the same
// weights are summed in another order (a count times the weight, parts,
// lanes, runs), which the checks hold to 1e-5 relative under the
// explained-mismatch rule. The sort is a fixed network, so two launches
// give the same table.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pack.cuh"

namespace {

// ------------------------------------------------------------- product

// acc[r][c] += u·p over `depth` depths of a stage, for the thread's first
// COLS columns: one fmaf chain an accumulator, k ascending, a float4 along
// k feeding four
template <int COLS>
__device__ __forceinline__ void tile_mac(float (&acc)[TU][TI],
                                         const float* ut, int ustride,
                                         const float* ps, int depth) {
  for (int kk = 0; kk < depth; kk += 4) {
    float4 a[TU];
#pragma unroll
    for (int r = 0; r < TU; ++r)
      a[r] = *reinterpret_cast<const float4*>(ut + r * ustride + kk);
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const float4 b =
          *reinterpret_cast<const float4*>(ps + c * 16 * LDT + kk);
#pragma unroll
      for (int r = 0; r < TU; ++r) {
        float s = acc[r][c];
        s = fmaf(a[r].x, b.x, s);
        s = fmaf(a[r].y, b.y, s);
        s = fmaf(a[r].z, b.z, s);
        acc[r][c] = fmaf(a[r].w, b.w, s);
      }
    }
  }
}

// Scores (n, S), row-major, of users U (n, d) against the packed samples
// Pk: K3's main loop (exact_rank.cu) with an epilogue that writes the
// tile's scores where K3 counts them
template <bool RESIDENT>
__global__ void __launch_bounds__(kThreads, 1)
product_kernel(const float* __restrict__ U, const float* __restrict__ Pk,
               float* __restrict__ scores, int n, int S, int d, int dq,
               int nkc, int ldu, int NS) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  float* base = reinterpret_cast<float*>(smem + kFixed);
  float* us = base;
  float* ring = RESIDENT ? base + (size_t)BM * ldu : base;
  constexpr int kStage = RESIDENT ? kItemTile : kItemTile + kUserTile;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = (warp & 1) * 8 + (lane & 7);    // samples tx + 16c
  const int ty = (warp >> 1) * 4 + (lane >> 3);  // users ty + 16r
  const int user0 = blockIdx.x * BM;
  const int fills = (S + BN - 1) / BN * nkc;
  const int ahead = NS - 2;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], RESIDENT ? 1 : 1 + kThreads);
      mbar_init(&empty[s], kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  auto produce = [&](int f) {
    const int slot = f % NS;
    float* st = ring + (size_t)slot * kStage;
    if (!RESIDENT || tid == 0)
      mbar_wait(&empty[slot], ((f / NS) & 1) ^ 1);
    if (tid == 0) {
      constexpr unsigned kBytes = sizeof(float) * kItemTile;
      mbar_arrive_expect_tx(&full[slot], kBytes);
      bulk_g2s(st, Pk + (size_t)f * kItemTile, kBytes, &full[slot]);
    }
    if (!RESIDENT) {
      copy_users4(st + kItemTile, U, n, d, user0, f % nkc * BK, lane,
                  warp);
      cp_async_arrive(&full[slot]);
    }
  };
  for (int f = 0; f < ahead && f < fills; ++f) produce(f);

  if (RESIDENT) {
    for (int i = tid; i < BM * dq; i += kThreads) {
      const int r = i / dq, k = i - r * dq;
      us[(size_t)r * ldu + k] =
          user0 + r < n && k < d ? U[(size_t)(user0 + r) * d + k] : 0.f;
    }
  }
  __syncthreads();

  float acc[TU][TI];
#pragma unroll
  for (int r = 0; r < TU; ++r)
#pragma unroll
    for (int c = 0; c < TI; ++c) acc[r][c] = 0.f;

  for (int f = 0; f < fills; ++f) {
    if (f + ahead < fills) produce(f + ahead);
    const int slot = f % NS;
    mbar_wait(&full[slot], (f / NS) & 1);
    const int kc = f % nkc;
    const int k0 = kc * BK;
    const int depth = min(BK, dq - k0);      // a multiple of 4
    const float* st = ring + (size_t)slot * kStage;
    const float* ps = st + tx * LDT;
    const float* ut = RESIDENT ? us + (size_t)ty * ldu + k0
                               : st + kItemTile + ty * LDT;
    const int ustride = RESIDENT ? 16 * ldu : 16 * LDT;
    // a tile of at most 128 samples leaves columns c >= 8 of every thread
    // past S: they are not computed
    if (S - f / nkc * BN <= BN / 2)
      tile_mac<TI / 2>(acc, ut, ustride, ps, depth);
    else
      tile_mac<TI>(acc, ut, ustride, ps, depth);
    mbar_arrive(&empty[slot]);
    if (kc == nkc - 1) {
      // the sample tile is summed: its scores go out, 8 consecutive
      // samples of 4 users a warp store
      const int item0 = f / nkc * BN;
#pragma unroll
      for (int c = 0; c < TI; ++c) {
        const int item = item0 + tx + 16 * c;
#pragma unroll
        for (int r = 0; r < TU; ++r) {
          const int user = user0 + ty + 16 * r;
          if (item < S && user < n)
            scores[(size_t)user * S + item] = acc[r][c];
          acc[r][c] = 0.f;
        }
      }
    }
  }
}

// --------------------------------------------------------------- count

__host__ __device__ constexpr int ilog2(int x) {
  return x <= 1 ? 0 : 1 + ilog2(x / 2);
}

constexpr int kMaxE = 16;                  // keys a lane holds at most
constexpr int kParts = ilog2(kMaxE) + 1;   // parts a run has at most
constexpr int kRun = 32 * (2 * kMaxE - 1);  // samples of a run: 992
constexpr int kWarps = 8;                  // users a count block
constexpr size_t kCountSmem = sizeof(float) * kWarps * 2 * kRun;
constexpr size_t kScoreBudget = 48u << 20;  // bytes of a chunk's scores

// Compare-exchange of a lane's pairs a and b, ascending: the smaller key
// to a. With weights (W) the pairs move whole; without, only keys.
template <bool W>
__device__ __forceinline__ void cmpx(float& ka, float& wa, float& kb,
                                     float& wb) {
  if constexpr (W) {
    const bool sw = kb < ka;
    const float k0 = sw ? kb : ka, w0 = sw ? wb : wa;
    kb = sw ? ka : kb;
    wb = sw ? wa : wb;
    ka = k0;
    wa = w0;
  } else {
    const float lo = fminf(ka, kb);
    kb = fmaxf(ka, kb);
    ka = lo;
  }
}

// Exchange with the partner lane's register that `ok`/`ow` came from: the
// lower position keeps the smaller key (low), the upper the larger
template <bool W>
__device__ __forceinline__ void cmpx_lanes(float& k, float& w, float ok,
                                           float ow, bool low) {
  if constexpr (W) {
    const bool take = low ? ok < k : ok > k;
    k = take ? ok : k;
    w = take ? ow : w;
  } else {
    k = low ? fminf(k, ok) : fmaxf(k, ok);
  }
}

// Stages J, J/2, .., 1 of a merge, pairs r and r | J of each lane
template <int E, int J, bool W>
__device__ __forceinline__ void cleaners_in_lane(float (&k)[kMaxE],
                                                 float (&w)[kMaxE]) {
  if constexpr (J >= 1) {
#pragma unroll
    for (int r = 0; r < E; ++r)
      if ((r & J) == 0) cmpx<W>(k[r], w[r], k[r | J], w[r | J]);
    cleaners_in_lane<E, J / 2, W>(k, w);
  }
}

// The merges of size KK = 2 .. E, inside each lane: first the mirror
// stage (r against r ^ (KK - 1)), then the cleaners
template <int E, int KK, bool W>
__device__ __forceinline__ void sort_in_lanes(float (&k)[kMaxE],
                                              float (&w)[kMaxE]) {
  if constexpr (KK <= E) {
#pragma unroll
    for (int r = 0; r < E; ++r)
      if ((r & (KK / 2)) == 0)
        cmpx<W>(k[r], w[r], k[r ^ (KK - 1)], w[r ^ (KK - 1)]);
    cleaners_in_lane<E, KK / 4, W>(k, w);
    sort_in_lanes<E, KK * 2, W>(k, w);
  }
}

// Bitonic sort, ascending, of the warp's 32·E keys (and weights, W): lane
// l holds positions l·E .. l·E + E - 1 in k[0..E), w[0..E). Each merge
// of size kk begins with the mirror stage (position i against
// i ^ (kk - 1)) and goes on with i ^ j, so every exchange is ascending
// and a lane's direction never enters: a lane's own pairs are
// compare-exchanges, pairs across lanes (E apart or more) shuffles.
template <int E, bool W>
__device__ __forceinline__ void bitonic_sort(float (&k)[kMaxE],
                                             float (&w)[kMaxE], int lane) {
  sort_in_lanes<E, 2, W>(k, w);
#pragma unroll 1
  for (int kk = 2 * E; kk <= 32 * E; kk <<= 1) {
    {
      // the mirror stage: register r against register E - 1 - r of lane
      // lane ^ (kk / E - 1), the pairs of r and E - 1 - r together
      const int lm = kk / E - 1;
      const bool low = (lane & (kk / (2 * E))) == 0;
#pragma unroll
      for (int r = 0; r < (E + 1) / 2; ++r) {
        const int r2 = E - 1 - r;
        const float ok1 = __shfl_xor_sync(kFull, k[r2], lm);
        const float ok2 = __shfl_xor_sync(kFull, k[r], lm);
        float ow1 = 0.f, ow2 = 0.f;
        if constexpr (W) {
          ow1 = __shfl_xor_sync(kFull, w[r2], lm);
          ow2 = __shfl_xor_sync(kFull, w[r], lm);
        }
        cmpx_lanes<W>(k[r], w[r], ok1, ow1, low);
        if (r2 != r) cmpx_lanes<W>(k[r2], w[r2], ok2, ow2, low);
      }
    }
#pragma unroll 1
    for (int j = kk >> 2; j >= E; j >>= 1) {
      const int lm = j / E;
      const bool low = (lane & lm) == 0;
#pragma unroll
      for (int r = 0; r < E; ++r) {
        const float ok = __shfl_xor_sync(kFull, k[r], lm);
        float ow = 0.f;
        if constexpr (W) ow = __shfl_xor_sync(kFull, w[r], lm);
        cmpx_lanes<W>(k[r], w[r], ok, ow, low);
      }
    }
    cleaners_in_lane<E, E / 2, W>(k, w);
  }
}

// One part of a run: its `len` (<= 32·E) scores from sc (sample r·32 +
// lane to lane's register r: an order the sort forgets), padded with
// +inf, sorted into keys[0 .. 32·E). Where the part's weights are all
// equal (the stratified samples' |P_l|/s, one value a partition) the
// keys sort alone and a threshold's sum is a count times the weight;
// otherwise the weights sort with their keys and their suffix sums go
// to suf[0 .. 32·E). Returns the common weight, or NaN for the latter.
template <int E>
__device__ __forceinline__ float sort_part(const float* __restrict__ sc,
                                           const float* __restrict__ wt,
                                           int len, float* keys, float* suf,
                                           int lane) {
  float k[kMaxE], w[kMaxE];
  bool same = true;
  const float w0 = wt[0];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int s = r * 32 + lane;
    const float x = s < len ? sc[s] : INFINITY;
    k[r] = x != x ? -INFINITY : x;  // a NaN score never counts
    w[r] = s < len ? wt[s] : 0.f;
    same = same && (s >= len || w[r] == w0);
  }
  if (__all_sync(kFull, same)) {
    bitonic_sort<E, false>(k, w, lane);
#pragma unroll
    for (int r = 0; r < E; ++r) keys[lane * E + r] = k[r];
    return w0;
  }
  bitonic_sort<E, true>(k, w, lane);
  // suffix sums from the largest key down: over the lane's E, then the
  // sum of the lanes above it
  float acc = 0.f;
#pragma unroll
  for (int r = E - 1; r >= 0; --r) {
    acc = acc + w[r];
    w[r] = acc;
  }
  float above = acc;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_down_sync(kFull, above, o);
    if (lane + o < 32) above = above + y;
  }
  above = __shfl_down_sync(kFull, above, 1);
  if (lane == 31) above = 0.f;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    keys[lane * E + r] = k[r];
    suf[lane * E + r] = w[r] + above;
  }
  return NAN;
}

// Adds to acc[q] the weight of a part's samples above t[q]: idx = #{keys
// not above t} by binary search (the keys ascend, so those are a prefix;
// all of them for a NaN t), then suf[idx], or (len - idx)·weight where the
// part's weights are equal (the padding's +inf keys lie above every t
// below +inf, and idx = N from +inf on)
template <int N>
__device__ __forceinline__ void add_part(const float* keys, const float* suf,
                                         float weight, int len,
                                         const float (&t)[4],
                                         float (&acc)[4]) {
  int lo[4] = {0, 0, 0, 0};
#pragma unroll
  for (int step = N / 2; step > 0; step /= 2) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (!(keys[lo[q] + step - 1] > t[q])) lo[q] += step;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (!(keys[lo[q]] > t[q])) ++lo[q];
    float v;
    if (weight == weight)
      v = lo[q] < len ? (float)(len - lo[q]) * weight : 0.f;
    else
      v = lo[q] < N ? suf[lo[q]] : 0.f;
    acc[q] = acc[q] + v;
  }
}

// Where part E of a run starts: the run holds a part of 32·E samples for
// each bit E of its length in warps (`units`), largest first
__device__ __forceinline__ int part_offset(int units, int E) {
  return 32 * (units & ~(2 * E - 1));
}

// sort_part for each part of the run, E = kMaxE down to 1
template <int E>
__device__ __forceinline__ void sort_parts(const float* sc, const float* wt,
                                           int len, int units, float* keys,
                                           float* suf,
                                           float (&weight)[kParts],
                                           int lane) {
  if (units & E) {
    const int off = part_offset(units, E);
    weight[ilog2(E)] = sort_part<E>(sc + off, wt + off,
                                    min(32 * E, len - off), keys + off,
                                    suf + off, lane);
  }
  if constexpr (E > 1)
    sort_parts<E / 2>(sc, wt, len, units, keys, suf, weight, lane);
}

// add_part for each part of the run
template <int E>
__device__ __forceinline__ void add_parts(const float* keys, const float* suf,
                                          const float (&weight)[kParts],
                                          int len, int units,
                                          const float (&t)[4],
                                          float (&acc)[4]) {
  if (units & E) {
    const int off = part_offset(units, E);
    add_part<32 * E>(keys + off, suf + off, weight[ilog2(E)],
                     min(32 * E, len - off), t, acc);
  }
  if constexpr (E > 1)
    add_parts<E / 2>(keys, suf, weight, len, units, t, acc);
}

// Table rows of n users from their scores (n, S): one warp a user
__global__ void __launch_bounds__(kWarps * 32, 3)
count_kernel(const float* __restrict__ scores, const float* __restrict__ w,
             const float* __restrict__ thr, float* __restrict__ out, int n,
             int S, int tau) {
  extern __shared__ float csm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int user = blockIdx.x * kWarps + warp;
  if (user >= n) return;
  float* keys = csm + (size_t)warp * 2 * kRun;
  float* suf = keys + kRun;
  const float* srow = scores + (size_t)user * S;
  const float* trow = thr + (size_t)user * tau;
  float* orow = out + (size_t)user * tau;

  for (int run0 = 0; run0 < S; run0 += kRun) {
    const int len = min(kRun, S - run0);
    const int units = (len + 31) / 32;
    float weight[kParts];
    __syncwarp();  // the previous run's searches are done
    sort_parts<kMaxE>(srow + run0, w + run0, len, units, keys, suf, weight,
                   lane);
    __syncwarp();

    const bool first = run0 == 0, last = run0 + len == S;
    float tn[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = 32 * q + lane;
      tn[q] = j < tau ? trow[j] : 0.f;
    }
    for (int j0 = 0; j0 < tau; j0 += 4 * 32) {
      float t[4], acc[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // this group's thresholds; the next group's loads go out now
        const int j = j0 + 32 * q + lane, jn = j + 4 * 32;
        t[q] = tn[q];
        tn[q] = jn < tau ? trow[jn] : 0.f;
        acc[q] = first || j >= tau ? 0.f : orow[j];
      }
      add_parts<kMaxE>(keys, suf, weight, len, units, t, acc);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + 32 * q + lane;
        if (j < tau) orow[j] = last ? 1.f + acc[q] : acc[q];
      }
    }
  }
}

// --------------------------------------------------------------- launch

using ProductFn = void (*)(const float*, const float*, float*, int, int, int,
                           int, int, int, int);

ProductFn product_of(const Plan& p) {
  return p.resident ? product_kernel<true> : product_kernel<false>;
}

// Each kernel's shared-memory limit is raised once
cudaError_t prepare(ProductFn fn) {
  static ProductFn done[2] = {};
  static bool count_done = false;
  if (!count_done) {
    const cudaError_t e = cudaFuncSetAttribute(
        count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kCountSmem);
    if (e != cudaSuccess) return e;
    count_done = true;
  }
  int i = 0;
  for (; i < 2 && done[i]; ++i)
    if (done[i] == fn) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(fn),
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemOptin);
  if (e == cudaSuccess && i < 2) done[i] = fn;
  return e;
}

// Users a chunk: whole waves of product blocks whose scores fit the
// budget, else as many blocks as fit (at least one), and never more than n
cudaError_t users_a_chunk(int n, int S, int* chunk) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  long long blocks =
      (long long)(kScoreBudget / ((size_t)BM * S * sizeof(float)));
  if (blocks >= sms) blocks = blocks / sms * sms;
  if (blocks < 1) blocks = 1;
  const long long need = (n + BM - 1) / BM;
  *chunk = (int)((blocks < need ? blocks : need) * BM);
  return cudaSuccess;
}

}  // namespace

// out[0] = users a chunk, out[1] = floats of the workspace a K2 call at
// (n, d, S) needs: the packed samples, then one chunk's scores
extern "C" int k2_plan(int n, int d, int S, long long* out) {
  if (n < 0 || d <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  int chunk = 0;
  const cudaError_t e = users_a_chunk(n > 0 ? n : 1, S, &chunk);
  if (e != cudaSuccess) return (int)e;
  out[0] = chunk;
  out[1] = (long long)(packed_floats(S, d) + (size_t)chunk * S);
  return 0;
}

// The table (n, tau) of users U (n, d), samples P (S, d), weights w (S,)
// and thresholds thr (n, tau); work: a 16-byte-aligned buffer of
// k2_plan's floats; chunk: its users a chunk
extern "C" int k2_table_build(const float* U, const float* P, const float* w,
                              const float* thr, float* out, float* work,
                              int n, int d, int S, int tau, int chunk,
                              void* stream) {
  if (n <= 0 || tau <= 0) return 0;
  if (d <= 0 || S <= 0 || chunk <= 0 ||
      (reinterpret_cast<uintptr_t>(work) & 15u))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const Plan p = plan(d);
  const ProductFn fn = product_of(p);
  cudaError_t e = prepare(fn);
  if (e != cudaSuccess) return (int)e;
  const size_t total = packed_floats(S, d);
  const int pack_blocks =
      (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  pack_items_kernel<<<pack_blocks, 256, 0, st>>>(P, work, S, d, p.nkc,
                                                 total);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  float* sc = work + total;
  for (int c0 = 0; c0 < n; c0 += chunk) {
    const int cn = n - c0 < chunk ? n - c0 : chunk;
    fn<<<(cn + BM - 1) / BM, kThreads, p.smem, st>>>(
        U + (size_t)c0 * d, work, sc, cn, S, d, p.dq, p.nkc, p.ldu, p.S);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    count_kernel<<<(cn + kWarps - 1) / kWarps, kWarps * 32, kCountSmem,
                   st>>>(sc, w, thr + (size_t)c0 * tau,
                         out + (size_t)c0 * tau, cn, S, tau);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// The launches a K2 call at (n, d, S) makes and their kernels' resources:
// out[0..16] = users a product block, samples a tile, depths a stage,
// stages, user tile resident (1) or staged, the product's dynamic shared
// memory in bytes, blocks an SM, registers and local bytes a thread; the
// count's users a block, samples a run, dynamic shared memory, blocks an
// SM, registers and local bytes a thread; users a chunk; workspace bytes.
extern "C" int k2_launch_config(int n, int d, int S, long long* out) {
  if (n <= 0 || d <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const Plan p = plan(d);
  const ProductFn fn = product_of(p);
  cudaError_t e = prepare(fn);
  int pblocks = 0, cblocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &pblocks, reinterpret_cast<const void*>(fn), kThreads, p.smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &cblocks, count_kernel, kWarps * 32, kCountSmem);
  cudaFuncAttributes pa{}, ca{};
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&pa, reinterpret_cast<const void*>(fn));
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&ca, count_kernel);
  long long plan_out[2] = {0, 0};
  if (e == cudaSuccess) e = (cudaError_t)k2_plan(n, d, S, plan_out);
  if (e != cudaSuccess) return (int)e;
  const long long vals[16] = {
      BM, BN, BK, p.S, p.resident, (long long)p.smem, pblocks,
      pa.numRegs, (long long)pa.localSizeBytes, kWarps, kRun,
      (long long)kCountSmem, cblocks, ca.numRegs,
      (long long)ca.localSizeBytes, plan_out[0]};
  for (int i = 0; i < 16; ++i) out[i] = vals[i];
  out[16] = plan_out[1] * (long long)sizeof(float);
  return 0;
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
