// K2: Eq. (1) of Algorithm 1 — the rank-table rows of the build.
//
// Replaces the TPU kernel repro/kernels/table_build.py
// (_table_build_kernel / table_build_kernel_call), which the JAX build
// runs as a jnp sort + suffix sum (repro/core/rank_table.py
// estimate_table_rows).
//
//   T[i, j] = 1 + sum_s w_s * I[u_i·p_s > t_ij]
//
// with the same strict '>' as the plain version.
//
// Bound on the card: the IEEE-f32 product U·Samplesᵀ, 2·n·S·d FLOP,
// against reading U and the thresholds and writing the table once. The
// samples (S·d·4 bytes, 512 KB at the paper's Netflix size) do not fit
// in shared memory, so a block of 8 users streams them in chunks of 32:
// lane j of warp w computes u_w·p_j by a sequential fmaf chain, and the
// block keeps each user's S scores in shared memory. Then each lane
// holds up to 16 of its user's thresholds in registers and walks the S
// scores in order, adding w_s where score > t_j. The sum runs over s in
// ascending order; where the weights are dyadic (all |P_l|/s equal, as
// at Netflix's 17,770 items: 1777/64) every partial sum is exact, and the
// result equals the plain version's wherever the scores agree.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kUsers = 8;    // users per block, one warp each
constexpr int kChunk = 32;   // samples per shared-memory chunk, one per lane
constexpr int kTauReg = 16;  // thresholds per lane per pass

__global__ void __launch_bounds__(kUsers * 32)
table_build_kernel(const float* __restrict__ U, const float* __restrict__ P,
                   const float* __restrict__ w,
                   const float* __restrict__ thr, float* __restrict__ out,
                   int n, int d, int S, int tau, int stride) {
  extern __shared__ float smem[];
  float* us = smem;                      // (kUsers, stride)
  float* ps = us + kUsers * stride;      // (kChunk, stride)
  float* sc = ps + kChunk * stride;      // (kUsers, S)
  float* ws = sc + kUsers * S;           // (S,)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int user0 = blockIdx.x * kUsers;

  for (int i = threadIdx.x; i < kUsers * d; i += blockDim.x) {
    const int r = i / d, k = i % d;
    us[r * stride + k] = user0 + r < n ? U[(size_t)(user0 + r) * d + k] : 0.f;
  }
  for (int i = threadIdx.x; i < S; i += blockDim.x) ws[i] = w[i];

  for (int s0 = 0; s0 < S; s0 += kChunk) {
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < kChunk * d; i += blockDim.x) {
      const int r = i / d, k = i % d;
      ps[r * stride + k] = s0 + r < S ? P[(size_t)(s0 + r) * d + k] : 0.f;
    }
    __syncthreads();
    if (s0 + lane < S) {
      const float* ur = us + warp * stride;
      const float* pr = ps + lane * stride;
      float acc = 0.f;
      for (int k = 0; k < d; ++k) acc = fmaf(ur[k], pr[k], acc);
      sc[warp * S + s0 + lane] = acc;
    }
  }
  __syncthreads();

  const int user = user0 + warp;
  if (user >= n) return;
  const float* t = thr + (size_t)user * tau;
  float* o = out + (size_t)user * tau;
  const float* scu = sc + warp * S;
  for (int j0 = 0; j0 < tau; j0 += 32 * kTauReg) {
    float tr[kTauReg], acc[kTauReg];
#pragma unroll
    for (int r = 0; r < kTauReg; ++r) {
      const int j = j0 + lane + 32 * r;
      tr[r] = j < tau ? t[j] : INFINITY;
      acc[r] = 0.f;
    }
    for (int s = 0; s < S; ++s) {
      const float v = scu[s], wv = ws[s];
#pragma unroll
      for (int r = 0; r < kTauReg; ++r) acc[r] += v > tr[r] ? wv : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kTauReg; ++r) {
      const int j = j0 + lane + 32 * r;
      if (j < tau) o[j] = 1.f + acc[r];
    }
  }
}

}  // namespace

extern "C" int k2_table_build(const float* U, const float* P, const float* w,
                              const float* thr, float* out, int n, int d,
                              int S, int tau, void* stream) {
  if (n <= 0 || tau <= 0) return 0;
  // an odd row stride keeps the 32 lanes' sample rows on distinct banks
  const int stride = d % 2 == 0 ? d + 1 : d;
  const size_t smem =
      sizeof(float) * ((size_t)(kUsers + kChunk) * stride +
                       (size_t)kUsers * S + S);
  cudaError_t err = cudaFuncSetAttribute(
      table_build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kUsers - 1) / kUsers;
  table_build_kernel<<<blocks, kUsers * 32, smem, (cudaStream_t)stream>>>(
      U, P, w, thr, out, n, d, S, tau, stride);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
