// K1: fused u·q + rank-table lookup, §4.3 step 1 of the query.
//
// Replaces the TPU kernel repro/kernels/user_scores.py
// (_bound_rank_batched_kernel / bound_ranks_batched_kernel_call, and its
// B = 1 twin _bound_rank_kernel, which is this kernel called with B = 1).
//
// For each user u and query b (B <= 16 per launch):
//   s    = u·q_b, a fixed-order f32 FMA dot product
//   idx  = #{j < tau : t_j <= s}
//   r_up = T[idx-1], or m+1 when idx = 0;  r_lo = T[idx], or 1 when idx = tau
//   est  = lerp between the bracketing thresholds inside the grid,
//          margin-decayed outside it, clipped to [r_lo, r_up], minus the
//          sub-unit tie-break 0.5·m_above/(1+m_above)
// literally as the plain version (repro_torch/core/query.py
// lookup_bounds_batch). The thresholds row is ascending (the build's grid).
//
// Bound on the card: memory. Each user row (4d bytes) is read once; per
// user and query, a search of the thresholds row and two table values.
// At one query the least a search reads is a binary search over the
// row's 32-byte sectors, ⌈log2(sectors)⌉ + 1 of them; at 16 queries the
// searches cover the whole row, which is then read once for all of them.
//
// Design: the step-1 ring kernel of step1_ring.cuh (K4/K5's, here of kind
// kF32: f32 rows, thresholds and table, no slack, one key a query). A
// producer warp stages tiles of consecutive user rows into a shared-memory
// ring by cp.async.bulk on mbarriers; eight consumer warps score them from
// shared memory, so no consumer waits on a user row in DRAM; the grid is
// persistent.
//   - At more than one query the thresholds rows ride the ring too, and
//     every lane binary-searches its query's staged row in shared memory;
//     where a row does not fit a stage (large tau) it is searched in
//     global memory, 512 values at a time staged in the warp's scratch.
//   - At one query the thresholds rows are not staged (at Netflix size
//     they are 960 MB, more than the whole bound). A warp scores 32 rows,
//     row i's score kept by lane i; then every lane searches its own
//     user's row in global memory at once and issues its table gathers,
//     which overlap the warp's next score. The search (sector_count)
//     reads whole 32-byte sectors: t[0] and t[tau-1], then the sector(s)
//     of the column that the build's even grid puts s at, which hold the
//     count unless the row is not even, and only then a bisection of the
//     sectors left. On the build's grid that is three or four sectors a
//     user in two rounds (K1's first kernel read 16 probes, a 128-byte
//     segment and both edges in four); 32 searches are in flight a warp.
//   - Behind a row map (K6) the producer reads each tile's map entry once;
//     consumers get row addresses without a dependent load.
//   - Rows too long for two stages of one row each (d past about 25,000)
//     stream through the ring in chunks, each lane keeping its k-set.
// Only the instances a call can reach are built: one query never stages
// its thresholds rows.
//
// The elastic entry (k1_bound_ranks_elastic) is this kernel over operands
// padded to a capacity, reading the valid row count from device memory;
// it replaces the TPU kernel's tile unit repro/kernels/ops.py
// bound_ranks_tile inside the elastic program (core/elastic.py).
//
// Contract: the outputs are bitwise those of K1's first kernel, at every
// B and on every input it takes (any n, d, B, tau >= 1, block_n; views at
// any 4-byte offset; duplicate and unordered ids under K6):
//   - every score is lane l's fmaf chain over k = l, l+32, ... from 0.0f,
//     the 32 partial sums reduced by recursive halving (step1_common.cuh
//     dot_chunk and halve; two rows a warp share each Qᵀ value in
//     dot_rows2, each with its own chain), so a score does not depend on
//     the query count, the layout or where the row is read;
//   - a count does not depend on the search on an ascending row;
//   - est keeps the first kernel's operations in their order (est_f32).
//
// K6 (k6_bound_ranks_masked) is this kernel behind a row map. It replaces
// the TPU kernel repro/kernels/user_scores.py
// bound_ranks_batched_masked_kernel_call, the masked grid of block
// pruning: compact rows [e·block_n, (e+1)·block_n) read global rows from
// ids[e]·block_n on, and a compact row past n (the tail block's padding)
// is written as m + 2 in all three outputs. Every other row computes
// exactly what K1 computes for that user, so the kept tiles of K6 are
// bitwise K1's outputs on the same rows.
#include <cuda_runtime.h>

#include "step1_ring.cuh"

namespace {

template <int NB, bool MASKED, bool THR, bool CHUNKED>
KernelFn k1() {
  return step1_ring_kernel<NB, kF32, float, MASKED, THR, CHUNKED>;
}

// One query: rows whole or chunked, thresholds never staged; several:
// thresholds staged or searched in place, or rows chunked
template <bool MASKED>
KernelFn pick_f32(int nb, const Layout& L) {
  if (L.nch > 1) return pick_nb<kF32, float, MASKED, false, true>(nb);
  if (nb == 1) return k1<1, MASKED, false, false>();
  if (!L.thr) return pick_nb<kF32, float, MASKED, false, false>(nb);
  switch (nb) {
    case 2: return k1<2, MASKED, true, false>();
    case 4: return k1<4, MASKED, true, false>();
    case 8: return k1<8, MASKED, true, false>();
    default: return k1<16, MASKED, true, false>();
  }
}

KernelFn resolve_f32(int, bool, int nb, bool masked, const Layout& L) {
  return masked ? pick_f32<true>(nb, L) : pick_f32<false>(nb, L);
}

// ids == nullptr is the identity map over n rows
int run_f32(const float* U, const float* Q, const float* thr,
            const float* tab, const int* ids, float* r_lo, float* r_up,
            float* est, int n, int d, int B, int tau, int ldo,
            float m_plus_1, int rows, int block_n, const int* n_valid,
            void* stream) {
  Args a{};
  a.U = U;
  a.Q = Q;
  a.thr = thr;
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
  a.ids = ids;
  a.block_n = block_n;
  a.rows = rows;
  a.n_valid = n_valid;
  return run(a, kF32, 1, resolve_f32, stream);
}

}  // namespace

// Outputs are user-major with row stride ldo: out[user * ldo + b]. The
// arrays may start at any 4-byte address and d may be any length.
extern "C" int k1_bound_ranks(const float* U, const float* Q,
                              const float* thr, const float* tab,
                              float* r_lo, float* r_up, float* est, int n,
                              int d, int B, int tau, int ldo,
                              float m_plus_1, void* stream) {
  return run_f32(U, Q, thr, tab, nullptr, r_lo, r_up, est, n, d, B, tau, ldo,
                 m_plus_1, n, 1, nullptr, stream);
}

// K1's elastic entry: operands padded to a capacity of `cap` rows, and the
// valid row count read on the device from n_valid (one int32) when the
// kernel starts, so that one launch (a CUDA graph's node) serves any
// count. Rows below *n_valid are bitwise k1_bound_ranks's; rows at or
// past it are not written.
extern "C" int k1_bound_ranks_elastic(const float* U, const float* Q,
                                      const float* thr, const float* tab,
                                      const int* n_valid, float* r_lo,
                                      float* r_up, float* est, int cap,
                                      int d, int B, int tau, int ldo,
                                      float m_plus_1, void* stream) {
  return run_f32(U, Q, thr, tab, nullptr, r_lo, r_up, est, cap, d, B, tau,
                 ldo, m_plus_1, cap, 1, n_valid, stream);
}

// K6: K1 over the nk tiles of block_n rows named by ids (nk,); outputs
// are compact, (nk·block_n) rows with row stride ldo, in list order.
extern "C" int k6_bound_ranks_masked(const float* U, const float* Q,
                                     const float* thr, const float* tab,
                                     const int* ids, float* r_lo,
                                     float* r_up, float* est, int n, int d,
                                     int B, int tau, int ldo,
                                     float m_plus_1, int nk, int block_n,
                                     void* stream) {
  return run_f32(U, Q, thr, tab, ids, r_lo, r_up, est, n, d, B, tau, ldo,
                 m_plus_1, nk * block_n, block_n, nullptr, stream);
}

// The launch a K1 (masked 0) or K6 (masked 1) call at these sizes makes,
// and its kernel's resources (out[0..9] as step1_ring.cuh's
// launch_config).
extern "C" int k1_launch_config(int B, int d, int tau, int masked,
                                int* out) {
  return launch_config(kF32, 1, B, d, tau, masked, resolve_f32, out);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
