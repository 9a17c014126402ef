// The tiling of the f32 product U·Pᵀ shared by K3 (exact_rank.cu) and K2
// (table_build.cu): a block of 256 threads owns BM = 128 users and walks
// P in tiles of BN = 256 rows, a thread holding an 8 x 16 register tile;
// P is packed once per call, stage by stage of a ring of BK = 32 depths,
// so that each stage fills by one bulk copy; the user tile stays resident
// in shared memory while it and three stages fit (d <= 228) and otherwise
// rides the ring by 4-byte cp.async. The design and its reasons are in
// exact_rank.cu's header.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "ring.cuh"

namespace {

constexpr int BM = 128;        // users per block
constexpr int BN = 256;        // items per tile
constexpr int BK = 32;         // depths a stage holds
constexpr int TU = BM / 16;    // users per thread
constexpr int TI = BN / 16;    // items per thread
constexpr int LDT = BK + 4;    // row stride of a stage's tiles, floats
constexpr int kThreads = 256;
constexpr int kMaxStages = 4;
constexpr int kMinStages = 3;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kSmemOptin = 227 * 1024;
constexpr int kItemTile = BN * LDT;                 // floats a stage's items
constexpr int kUserTile = BM * LDT;                 // and users
// barriers (full, empty), then two words a user (K3's u·q and partial
// counts; unused by K2)
constexpr size_t kFixed = 2 * kMaxStages * 8 + 2 * BM * 4;

struct Plan {
  int dq;        // depth the products run to: d rounded up to 4
  int nkc;       // stages an item tile takes
  int ldu;       // row stride of the resident user tile, floats
  int resident;  // the user tile stays in shared memory
  int S;         // ring stages
  size_t smem;   // dynamic shared memory
};

Plan plan(int d) {
  Plan p;
  p.dq = (d + 3) / 4 * 4;
  p.nkc = (p.dq + BK - 1) / BK;
  // an odd number of 16-byte chunks a row spreads the rows over the banks
  p.ldu = p.dq / 4 % 2 ? p.dq : p.dq + 4;
  const size_t users = sizeof(float) * (size_t)BM * p.ldu;
  for (int S = kMaxStages; S >= kMinStages; --S) {
    const size_t need = kFixed + users + S * sizeof(float) * kItemTile;
    if (need <= kSmemOptin) {
      p.resident = 1;
      p.S = S;
      p.smem = need;
      return p;
    }
  }
  p.resident = 0;
  p.S = kMaxStages;
  p.smem = kFixed + p.S * sizeof(float) * (kItemTile + kUserTile);
  return p;
}

// Floats of the packed P: a stage of BN x LDT for each item tile and each
// BK depths
size_t packed_floats(int m, int d) {
  const Plan p = plan(d);
  return (size_t)(m + BN - 1) / BN * p.nkc * kItemTile;
}

// The pack: stage (tile t, depths c·BK..) of P at Pk + (t·nkc + c)·BN·LDT,
// row r holding item t·BN + r at depths c·BK .. +BK, zero past m and d
__global__ void pack_items_kernel(const float* __restrict__ P,
                                  float* __restrict__ Pk, int m, int d,
                                  int nkc, size_t total) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t stage = i / kItemTile;
    const int e = (int)(i - stage * kItemTile);
    const int r = e / LDT, kk = e % LDT;
    const int item = (int)(stage / nkc) * BN + r;
    const int k = (int)(stage % nkc) * BK + kk;
    Pk[i] = kk < BK && item < m && k < d ? P[(size_t)item * d + k] : 0.f;
  }
}

// Users [user0, user0 + BM) x depths [k0, k0 + BK) of U (row-major, d a
// row) into a stage's user tile (row stride LDT) by this thread's share of
// 4-byte cp.async, zero past n and past d; warp w's copy e covers 4 users
// x 8 depths (4 runs of 32 bytes), b = e·8 + w.
__device__ __forceinline__ void copy_users4(float* tile, const float* U,
                                            int n, int d, int user0, int k0,
                                            int lane, int warp) {
  constexpr int kb = BK / 8;
#pragma unroll
  for (int e = 0; e < BK * BM / kThreads; ++e) {
    const int b = e * 8 + warp;
    const int kk = (b % kb) * 8 + (lane & 7);
    const int rr = (b / kb) * 4 + (lane >> 3);
    const int r = user0 + rr, k = k0 + kk;
    const bool in = r < n && k < d;
    cp_async4(tile + rr * LDT + kk, in ? U + (size_t)r * d + k : U,
              in ? 4u : 0u);
  }
}

}  // namespace
