// K3: exact ranks by Definition 1 — the oracle that grades the answers.
//
// Replaces the TPU kernel repro/kernels/exact_rank.py
// (_exact_rank_kernel / exact_counts_kernel_call).
//
//   rank(u) = 1 + #{p in P : u·p > u·q}, counted in int32
//
// Bound on the card: operations, 2·n·m·d FLOP of IEEE-f32 products per
// query. A block owns a tile of 64 users, keeps it in shared memory for
// the whole item stream, and walks P in tiles of 64 items x 16 depth;
// each of its 256 threads accumulates a 4x4 register tile of u·p and
// counts, in registers, the items that beat u·q. Counts stay in the
// kernel across the whole stream: no partial buffer, no padding of P
// (the ragged tail is masked).
//
// u·q is computed by exactly the same fmaf chain as every u·p (k = 0 .. d-1
// from 0.0f; the zero padding of the last depth tile adds +0), so for
// q in P the item equal to q never counts against itself.
//
// The user tile stays resident while its dp x 68 floats fit in the 227 KB
// of shared memory a block may opt in to (d <= 832); above that it is
// staged 16 depths at a time beside the item tile, as a plain tiled
// product. Either way every sum runs over k in the same ascending order.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;       // users per block
constexpr int BN = 64;       // items per tile
constexpr int BK = 16;       // depth per item tile step
constexpr int LD = BM + 4;   // shared row stride (multiple of 4 for float4)
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kSmemOptin = 227 * 1024;

// RESIDENT: the user tile holds all dp depths for the whole item stream;
// otherwise it holds the BK depths of the current step
template <bool RESIDENT>
__global__ void __launch_bounds__(256)
exact_rank_kernel(const float* __restrict__ U, const float* __restrict__ P,
                  const float* __restrict__ q, int* __restrict__ ranks,
                  int n, int m, int d, int dp) {
  extern __shared__ __align__(16) float smem[];
  float* us = smem;              // (dp or BK, LD): us[k * LD + i], k-major
  float* bs = us + (RESIDENT ? dp : BK) * LD;  // (BK, LD): bs[kk * LD + j]
  float* uq_s = bs + BK * LD;    // (BM,)
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int user0 = blockIdx.x * BM;

  if (RESIDENT) {
    for (int i = tid; i < BM * dp; i += 256) {
      const int r = i / dp, k = i % dp;
      const int user = user0 + r;
      us[k * LD + r] = (user < n && k < d) ? U[(size_t)user * d + k] : 0.f;
    }
  }
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
  float uq[4];
  int cnt[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) { uq[r] = uq_s[ty * 4 + r]; cnt[r] = 0; }

  for (int item0 = 0; item0 < m; item0 += BN) {
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    for (int k0 = 0; k0 < dp; k0 += BK) {
      for (int i = tid; i < BN * BK; i += 256) {
        const int c = i / BK, kk = i % BK;
        const int item = item0 + c, k = k0 + kk;
        bs[kk * LD + c] =
            (item < m && k < d) ? P[(size_t)item * d + k] : 0.f;
      }
      if (!RESIDENT) {
        for (int i = tid; i < BM * BK; i += 256) {
          const int r = i / BK, kk = i % BK;
          const int user = user0 + r, k = k0 + kk;
          us[kk * LD + r] =
              (user < n && k < d) ? U[(size_t)user * d + k] : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(
            us + ((RESIDENT ? k0 : 0) + kk) * LD + ty * 4);
        const float4 b =
            *reinterpret_cast<const float4*>(bs + kk * LD + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (item0 + tx * 4 + c < m) {
#pragma unroll
        for (int r = 0; r < 4; ++r) cnt[r] += acc[r][c] > uq[r] ? 1 : 0;
      }
    }
  }
  // the 16 threads of one ty sit in one half-warp: reduce across tx
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      cnt[r] += __shfl_xor_sync(kFull, cnt[r], off);
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int user = user0 + ty * 4 + r;
      if (user < n) ranks[user] = 1 + cnt[r];
    }
  }
}

}  // namespace

extern "C" int k3_exact_ranks(const float* U, const float* P, const float* q,
                              int* ranks, int n, int m, int d,
                              void* stream) {
  if (n <= 0) return 0;
  if (d <= 0) return (int)cudaErrorInvalidValue;
  const int dp = (d + BK - 1) / BK * BK;
  const size_t whole = sizeof(float) * ((size_t)dp * LD + BK * LD + BM);
  const bool resident = whole <= kSmemOptin;
  const size_t smem =
      resident ? whole : sizeof(float) * ((size_t)2 * BK * LD + BM);
  auto kernel = resident ? exact_rank_kernel<true> : exact_rank_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + BM - 1) / BM;
  kernel<<<blocks, 256, smem, (cudaStream_t)stream>>>(U, P, q, ranks, n, m,
                                                      d, dp);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
