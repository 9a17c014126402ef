// K3: exact ranks by Definition 1 — the oracle that grades the answers.
//
// Replaces the TPU kernel repro/kernels/exact_rank.py
// (_exact_rank_kernel / exact_counts_kernel_call), one query q a launch:
//
//   rank(u) = 1 + #{p in P : u·p > u·q}, counted in int32
//
// Bound on the card: operations, 2·n·m·d FLOP of IEEE-f32 products per
// query (3.41e12 at Netflix size, 51 ms at the 67 TFLOP/s of f32 outside
// the tensor cores). Tensor cores are out: TF32 moves scores by about
// 1e-3 relative and flips ranks. P (m·d floats) stays in the 50 MB L2; U
// is read once. What limits a product of f32 on this card is the path
// from shared memory to registers: an SM issues 128 FFMA a clock but
// delivers 128 bytes of shared memory a clock, so a thread must reuse
// each value it loads across many FFMA, and the copies that fill shared
// memory must take as little of that path, and as few instructions, as
// they can.
//
// Every score is one fmaf chain over k ascending from 0.0f: u·q by one
// thread per user, every u·p by the tiles below (each accumulator takes
// its k terms in order, four at a time from a float4 along k), with zero
// padding of the depth adding only +0 at the end. So for q in P the item
// equal to q never counts against itself, and the counts do not depend on
// the tiling.
//
// Design (the tiling, the pack and the user copies are in pack.cuh, which
// K2 shares). A block of 256 threads owns 128 users and walks P in tiles of
// 256 items. A thread holds an 8 x 16 register tile of u·p (users
// ty + 16r, items tx + 16c): for four depths it reads 8 float4 of user
// values and 16 of item values from shared memory for 512 FFMA, 3 bytes
// of shared memory an FFMA (the parent's 4 x 4 tile read 8). Tiles are
// item-major (user-major), k contiguous: a quarter warp reads 8
// consecutive items whose rows are an odd number of 16-byte chunks apart
// (LDT = 36 floats), so its reads are free of bank conflicts, and its
// user reads are one broadcast address.
//   First a pack launch lays P out stage by stage in a workspace: for
// each tile of 256 items and each 32 depths, the 256 x LDT floats a stage
// holds, zero past m and past d, contiguous. P streams through a ring of
// S stages, each filled by ONE 1-D bulk copy (cp.async.bulk) that one
// thread issues, completing on the stage's "full" mbarrier; the copies
// run S - 2 stages ahead of the FFMAs, and every thread releases a stage
// on its "empty" mbarrier, so no block-wide barrier stands in the loop
// (ring.cuh; a wait traps rather than hanging). The user tile stays
// resident in shared memory (read once by ordinary loads) while it and a
// ring of three stages fit (d <= 228), and otherwise rides the ring, 128
// users x 32 depths a stage, by each thread's 4-byte cp.async,
// zero-filled past n and d, which arrive on the same barrier. U, P and q
// may start at any 4-byte address and d may be any length.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pack.cuh"

namespace {

template <bool RESIDENT>
__global__ void __launch_bounds__(kThreads, 1)
exact_rank_kernel(const float* __restrict__ U, const float* __restrict__ Pk,
                  const float* __restrict__ q, int* __restrict__ ranks,
                  int n, int m, int d, int dq, int nkc, int ldu, int S) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  float* uq_s = reinterpret_cast<float*>(empty + kMaxStages);  // (BM,)
  int* cnt_s = reinterpret_cast<int*>(uq_s + BM);               // (BM,)
  float* base = reinterpret_cast<float*>(cnt_s + BM);
  // resident: the user tile (BM, ldu), then S item tiles; else S stages
  // of (item tile, user tile)
  float* us = base;
  float* ring = RESIDENT ? base + (size_t)BM * ldu : base;
  constexpr int kStage = RESIDENT ? kItemTile : kItemTile + kUserTile;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = (warp & 1) * 8 + (lane & 7);    // items tx + 16c
  const int ty = (warp >> 1) * 4 + (lane >> 3);  // users ty + 16r
  const int user0 = blockIdx.x * BM;
  const int fills = (m + BN - 1) / BN * nkc;
  const int ahead = S - 2;                 // fills in flight ahead of use

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      // the bulk copy's thread, and every thread's cp.async of users
      mbar_init(&full[s], RESIDENT ? 1 : 1 + kThreads);
      mbar_init(&empty[s], kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // fill f (packed stage f: item tile f / nkc, depths (f % nkc)·BK..)
  // into slot f % S
  auto produce = [&](int f) {
    const int slot = f % S;
    float* st = ring + (size_t)slot * kStage;
    if (!RESIDENT || tid == 0)
      mbar_wait(&empty[slot], ((f / S) & 1) ^ 1);
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
    // the user tile, once, zero past n and past d to dq
    for (int i = tid; i < BM * dq; i += kThreads) {
      const int r = i / dq, k = i - r * dq;
      us[(size_t)r * ldu + k] =
          user0 + r < n && k < d ? U[(size_t)(user0 + r) * d + k] : 0.f;
    }
  }
  // u·q: one fmaf chain a user, k = 0 .. d-1 from 0.0f
  if (tid < BM) {
    float a = 0.f;
    const int user = user0 + tid;
    if (user < n) {
      const float* u = U + (size_t)user * d;
      for (int k = 0; k < d; ++k) a = fmaf(u[k], q[k], a);
    }
    uq_s[tid] = a;
  }
  __syncthreads();
  float uq[TU];
  int cnt[TU];
#pragma unroll
  for (int r = 0; r < TU; ++r) {
    uq[r] = uq_s[ty + 16 * r];
    cnt[r] = 0;
  }

  float acc[TU][TI];
#pragma unroll
  for (int r = 0; r < TU; ++r)
#pragma unroll
    for (int c = 0; c < TI; ++c) acc[r][c] = 0.f;

  for (int f = 0; f < fills; ++f) {
    if (f + ahead < fills) produce(f + ahead);
    const int slot = f % S;
    mbar_wait(&full[slot], (f / S) & 1);
    const int kc = f % nkc;
    const int k0 = kc * BK;
    const int depth = min(BK, dq - k0);      // a multiple of 4
    const float* st = ring + (size_t)slot * kStage;
    const float* ps = st + tx * LDT;
    const float* ut = RESIDENT ? us + (size_t)ty * ldu + k0
                               : st + kItemTile + ty * LDT;
    const int ustride = RESIDENT ? 16 * ldu : 16 * LDT;
    for (int kk = 0; kk < depth; kk += 4) {
      float4 a[TU];
#pragma unroll
      for (int r = 0; r < TU; ++r)
        a[r] = *reinterpret_cast<const float4*>(ut + r * ustride + kk);
#pragma unroll
      for (int c = 0; c < TI; ++c) {
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
    mbar_arrive(&empty[slot]);
    if (kc == nkc - 1) {
      // the item tile is summed: count the items that beat u·q
      const int item0 = f / nkc * BN;
#pragma unroll
      for (int c = 0; c < TI; ++c) {
        if (item0 + tx + 16 * c < m) {
#pragma unroll
          for (int r = 0; r < TU; ++r) cnt[r] += acc[r][c] > uq[r] ? 1 : 0;
        }
      }
#pragma unroll
      for (int r = 0; r < TU; ++r)
#pragma unroll
        for (int c = 0; c < TI; ++c) acc[r][c] = 0.f;
    }
  }

  // the 8 lanes of one ty in a warp, then the two warps of one ty
#pragma unroll
  for (int r = 0; r < TU; ++r)
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      cnt[r] += __shfl_xor_sync(kFull, cnt[r], off);
  const bool head = (lane & 7) == 0;
  if (head && (warp & 1) == 0) {
#pragma unroll
    for (int r = 0; r < TU; ++r) cnt_s[ty + 16 * r] = cnt[r];
  }
  __syncthreads();
  if (head && (warp & 1) == 1) {
#pragma unroll
    for (int r = 0; r < TU; ++r) {
      const int j = ty + 16 * r;
      if (user0 + j < n) ranks[user0 + j] = 1 + cnt_s[j] + cnt[r];
    }
  }
}

using KernelFn = void (*)(const float*, const float*, const float*, int*,
                          int, int, int, int, int, int, int);

KernelFn kernel_of(const Plan& p) {
  return p.resident ? exact_rank_kernel<true> : exact_rank_kernel<false>;
}

// A kernel's shared-memory limit is raised once, to the most any plan asks
cudaError_t prepare(KernelFn fn) {
  static KernelFn done[2] = {};
  int i = 0;
  for (; i < 2 && done[i]; ++i)
    if (done[i] == fn) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(fn),
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemOptin);
  if (e == cudaSuccess && i < 2) done[i] = fn;
  return e;
}

}  // namespace

// Floats of the workspace a K3 call at (m, d) needs (the packed P)
extern "C" int k3_workspace_floats(int m, int d, long long* out) {
  if (m < 0 || d <= 0) return (int)cudaErrorInvalidValue;
  *out = (long long)packed_floats(m, d);
  return 0;
}

// ranks (n,) of users U (n, d) against items P (m, d) for the query q (d,);
// work is a caller's buffer of k3_workspace_floats(m, d) floats, 16-byte
// aligned
extern "C" int k3_exact_ranks(const float* U, const float* P, const float* q,
                              int* ranks, float* work, int n, int m, int d,
                              void* stream) {
  if (n <= 0) return 0;
  if (d <= 0 || m < 0 || (reinterpret_cast<uintptr_t>(work) & 15u))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(d);
  const KernelFn fn = kernel_of(p);
  cudaError_t e = prepare(fn);
  if (e != cudaSuccess) return (int)e;
  const size_t total = packed_floats(m, d);
  if (total > 0) {
    const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256
                                                         : 4096);
    pack_items_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
        P, work, m, d, p.nkc, total);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (n + BM - 1) / BM;
  fn<<<blocks, kThreads, p.smem, (cudaStream_t)stream>>>(
      U, work, q, ranks, n, m, d, p.dq, p.nkc, p.ldu, p.S);
  return (int)cudaGetLastError();
}

// The launch a K3 call at depth d makes and its kernel's resources:
// out[0..9] = users a block, items a tile, depths a stage, stages, user
// tile resident (1) or staged, dynamic shared memory in bytes, blocks an
// SM, registers a thread, local memory a thread in bytes (spills), the
// depth the products run to.
extern "C" int k3_launch_config(int d, int* out) {
  if (d <= 0) return (int)cudaErrorInvalidValue;
  const Plan p = plan(d);
  const KernelFn fn = kernel_of(p);
  cudaError_t e = prepare(fn);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, reinterpret_cast<const void*>(fn), kThreads, p.smem);
  cudaFuncAttributes fa{};
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&fa, reinterpret_cast<const void*>(fn));
  if (e != cudaSuccess) return (int)e;
  out[0] = BM;
  out[1] = BN;
  out[2] = BK;
  out[3] = p.S;
  out[4] = p.resident;
  out[5] = (int)p.smem;
  out[6] = blocks;
  out[7] = fa.numRegs;
  out[8] = (int)fa.localSizeBytes;
  out[9] = p.dq;
  return 0;
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
