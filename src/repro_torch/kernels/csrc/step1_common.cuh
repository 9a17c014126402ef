// The score's helpers of the step-1 ring kernel (step1_ring.cuh), which
// K1/K6 (user_scores.cu) and K4/K5/K7 (user_scores_quant.cu) instance: Qᵀ
// in shared memory, lane l accumulating u_k·q_bk over k = l, l+32, ...
// with one fmaf chain from 0.0f, the 32 partial sums reduced by
// recursive halving, so that a row's score is bitwise the same in every
// instance.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;     // users in flight per block, one warp each
constexpr int kMaxB = 16;     // queries per launch
constexpr int kUChunk = 8;    // user-row values each lane loads at once
constexpr int kTChunk = 16;   // thresholds each lane loads at once
constexpr int kTile = 32 * kTChunk;  // thresholds a warp searches at once
constexpr unsigned kFull = 0xffffffffu;
constexpr int kQChunk = 256;  // rows of Qᵀ a streamed chunk holds

// Row stride of Qᵀ in shared memory: lanes read a row each as float4s,
// and a stride of 20 (NB = 16) or 12 (NB = 8) floats keeps the eight
// lanes of a quarter-warp on distinct banks.
template <int NB>
__host__ __device__ constexpr int q_stride() { return NB >= 8 ? NB + 4 : NB; }

template <int NB>
__host__ __device__ constexpr int log2_nb() {
  return NB >= 16 ? 4 : NB >= 8 ? 3 : NB >= 4 ? 2 : NB >= 2 ? 1 : 0;
}

// Sum v[b] over the 32 lanes for all b < NB. While a lane holds CUR > 1
// values it keeps half of them and adds its partner's copy of that half;
// with one value left it finishes as an xor butterfly. Lane l ends with
// the sum of query l >> (5 - log2 NB) in v[0].
template <int NB, int CUR, int OFF, typename T>
__device__ __forceinline__ void halve(T (&v)[NB], int lane) {
  if constexpr (CUR > 1) {
    constexpr int kHalf = CUR / 2;
    const bool upper = (lane & OFF) != 0;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const T send = upper ? v[i] : v[i + kHalf];
      const T keep = upper ? v[i + kHalf] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, OFF);
    }
    halve<NB, kHalf, OFF / 2>(v, lane);
  } else {
#pragma unroll
    for (int off = OFF; off > 0; off >>= 1)
      v[0] += __shfl_xor_sync(kFull, v[0], off);
  }
}

// Rows [c0, c0 + len) of Qᵀ into shared memory, qs[k - c0][b], by
// threads tid, tid + nthreads, ...
template <int NB>
__device__ __forceinline__ void stage_q(float* qs, const float* Q, int B,
                                        int d, int c0, int len, int tid,
                                        int nthreads) {
  constexpr int kStride = q_stride<NB>();
  for (int i = tid; i < len * NB; i += nthreads) {
    const int k = i / NB, b = i % NB;
    qs[k * kStride + b] = b < B ? Q[(size_t)b * d + c0 + k] : 0.f;
  }
}

// The same by every thread of the block
template <int NB>
__device__ __forceinline__ void stage_q(float* qs, const float* Q, int B,
                                        int d, int c0, int len) {
  stage_q<NB>(qs, Q, B, d, c0, len, threadIdx.x, blockDim.x);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

// acc[b] += u_k·q_bk over this lane's k in [c0, c1), one fmaf each in
// ascending k, the row widened to f32; qs holds rows c0.. of Qᵀ
template <int NB, typename RowT>
__device__ __forceinline__ void dot_chunk(float (&acc)[NB],
                                          const RowT* __restrict__ u,
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

}  // namespace
