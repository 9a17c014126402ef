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
//
// Shapes of any size: where the 8 user rows, a 32-sample chunk and the S
// scores do not fit in the 227 KB of shared memory a block may opt in to,
// the depth is taken 256 at a time (the user rows then restaged with
// each sample chunk) and the samples in runs of at most `scap`, whose
// partial counts wait in the output row. Each dot product still runs
// over k in ascending order, and each count over s in ascending order
// from 0, so the table is bitwise the same however it is cut.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kUsers = 8;    // users per block, one warp each
constexpr int kChunk = 32;   // samples per shared-memory chunk, one per lane
constexpr int kTauReg = 16;  // thresholds per lane per pass
constexpr int kDepth = 256;  // depth of a chunk when the rows do not fit
constexpr size_t kSmemOptin = 227 * 1024;

// An odd row stride keeps the 32 lanes' sample rows on distinct banks
__host__ __device__ constexpr int row_stride(int dk) {
  return dk % 2 == 0 ? dk + 1 : dk;
}

size_t smem_bytes(int dk, int scap) {
  return sizeof(float) * ((size_t)(kUsers + kChunk) * row_stride(dk) +
                          (size_t)kUsers * scap + scap);
}

// dk: depth held at once (d: whole rows); scap: scores held at once
__global__ void __launch_bounds__(kUsers * 32)
table_build_kernel(const float* __restrict__ U, const float* __restrict__ P,
                   const float* __restrict__ w,
                   const float* __restrict__ thr, float* __restrict__ out,
                   int n, int d, int S, int tau, int dk, int scap) {
  extern __shared__ float smem[];
  const int stride = row_stride(dk);
  float* us = smem;                      // (kUsers, stride)
  float* ps = us + kUsers * stride;      // (kChunk, stride)
  float* sc = ps + kChunk * stride;      // (kUsers, scap)
  float* ws = sc + kUsers * scap;        // (scap,)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int user0 = blockIdx.x * kUsers;
  const bool resident = dk == d;
  const int user = user0 + warp;

  if (resident) {
    for (int i = threadIdx.x; i < kUsers * d; i += blockDim.x) {
      const int r = i / d, k = i % d;
      us[r * stride + k] =
          user0 + r < n ? U[(size_t)(user0 + r) * d + k] : 0.f;
    }
  }
  for (int sb = 0; sb < S; sb += scap) {
    const int slen = min(scap, S - sb);
    __syncthreads();  // the previous run's scores are consumed
    for (int i = threadIdx.x; i < slen; i += blockDim.x) ws[i] = w[sb + i];
    for (int s0 = 0; s0 < slen; s0 += kChunk) {
      float acc = 0.f;
      for (int k0 = 0; k0 < d; k0 += dk) {
        const int klen = min(dk, d - k0);
        __syncthreads();  // the previous chunk is consumed
        if (!resident) {
          for (int i = threadIdx.x; i < kUsers * klen; i += blockDim.x) {
            const int r = i / klen, k = i % klen;
            us[r * stride + k] =
                user0 + r < n ? U[(size_t)(user0 + r) * d + k0 + k] : 0.f;
          }
        }
        for (int i = threadIdx.x; i < kChunk * klen; i += blockDim.x) {
          const int r = i / klen, k = i % klen;
          const int s = sb + s0 + r;
          ps[r * stride + k] =
              s0 + r < slen ? P[(size_t)s * d + k0 + k] : 0.f;
        }
        __syncthreads();
        if (s0 + lane < slen) {
          const float* ur = us + warp * stride;
          const float* pr = ps + lane * stride;
          for (int k = 0; k < klen; ++k) acc = fmaf(ur[k], pr[k], acc);
        }
      }
      if (s0 + lane < slen) sc[warp * scap + s0 + lane] = acc;
    }
    __syncthreads();

    if (user < n) {
      const float* t = thr + (size_t)user * tau;
      float* o = out + (size_t)user * tau;
      const float* scu = sc + warp * scap;
      const bool last = sb + slen == S;
      for (int j0 = 0; j0 < tau; j0 += 32 * kTauReg) {
        float tr[kTauReg], acc[kTauReg];
#pragma unroll
        for (int r = 0; r < kTauReg; ++r) {
          const int j = j0 + lane + 32 * r;
          tr[r] = j < tau ? t[j] : INFINITY;
          // a count continues from the previous run's partial sum
          acc[r] = sb > 0 && j < tau ? o[j] : 0.f;
        }
        for (int s = 0; s < slen; ++s) {
          const float v = scu[s], wv = ws[s];
#pragma unroll
          for (int r = 0; r < kTauReg; ++r) acc[r] += v > tr[r] ? wv : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kTauReg; ++r) {
          const int j = j0 + lane + 32 * r;
          if (j < tau) o[j] = last ? 1.f + acc[r] : acc[r];
        }
      }
    }
  }
}

}  // namespace

extern "C" int k2_table_build(const float* U, const float* P, const float* w,
                              const float* thr, float* out, int n, int d,
                              int S, int tau, void* stream) {
  if (n <= 0 || tau <= 0) return 0;
  if (d <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  int dk = d, scap = S;
  if (smem_bytes(dk, scap) > kSmemOptin) {
    dk = d < kDepth ? d : kDepth;
    const size_t rest = kSmemOptin / sizeof(float) -
                        (size_t)(kUsers + kChunk) * row_stride(dk);
    const size_t cap = rest / (kUsers + 1) / kChunk * kChunk;
    scap = (size_t)S < cap ? S : (int)cap;
  }
  const size_t smem = smem_bytes(dk, scap);
  cudaError_t err = cudaFuncSetAttribute(
      table_build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kUsers - 1) / kUsers;
  table_build_kernel<<<blocks, kUsers * 32, smem, (cudaStream_t)stream>>>(
      U, P, w, thr, out, n, d, S, tau, dk, scap);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
