// K4 and K5: fused u·q + certified rank-table lookup on a quantized
// table, §4.3 step 1 of the query at the bf16 and int8 storage specs.
//
// K4 replaces the TPU kernel repro/kernels/user_scores.py
// _bound_rank_batched_bf16_kernel, K5 _bound_rank_batched_int8_kernel
// (both through bound_ranks_batched_quant_kernel_call). Each computes,
// literally as its plain version (repro_torch/core/query.py
// _lookup_bounds_bf16 / _lookup_bounds_int8 after user_scores_batch),
// for each user u and query b (B <= 16 per launch):
//   s     = Σ_k u_k·q_bk, a fixed-order f32 fmaf chain over the stored row
//           widened to f32 (bf16, int8 or f32 rows), times the user's
//           scale (K5)
//   slack = row_slack·‖q_b‖₁, with ‖q_b‖₁ given by the caller
// K4 (bf16 thresholds/table):
//   idx_hi = #{t̃ <= bf16(s + slack)}, idx_lo = #{t̃ < bf16(s − slack)}
//   (round to nearest even; bf16 → f32 is exact and monotone, so the
//   compares run in f32); r↑ = T̃[idx_lo−1]·(1+ε) or m+1 at idx_lo = 0;
//   r↓ = T̃[idx_hi]·(1−ε) or 1 at idx_hi = τ
// K5 (int8 table, thresholds never read):
//   s' = (s − off_t)/sc_t, δ' = slack/sc_t, dev = thr_dev + pad,
//   idx = clip(floor((v + 127)/Δ), −1, τ) + 1 at v = (s' ± δ') ± dev;
//   table codes dequantize as code·sc + off and widen by (½+pad)·sc;
//   the estimate's thresholds are the grid (cΔ − 127)·sc_t + off_t
// est interpolates between the thresholds around idx_hi with the
// unshifted score, as query._est_from_grid. The constants Δ, pad, ½+pad
// and 1±ε come from the host, each rounded once from double to f32 as
// the reference's literals are.
//
// Bound on the card: memory. K4 reads the bf16 user row (2d B) and, per
// query, two searches of the bf16 thresholds row and two table gathers;
// K5 reads the int8 row (d B), seven per-user f32 scalars and two int8
// table codes per query, and no thresholds at all.
//
// Design (the kernel and its host plan are in step1_ring.cuh, which K1/K6
// share): rows stream through shared memory in tiles of T consecutive
// users. A block is eight consumer warps and one producer warp, and the
// grid is persistent (the blocks that fit the SMs at once, each taking
// every gridDim-th tile). The producer keeps a ring of S stages full:
// for each tile, one elected lane issues one bulk asynchronous copy
// (cp.async.bulk, the 1-D form of TMA) per array, completing on the
// stage's mbarrier: the stored rows, K4's bf16 thresholds rows, and the
// tile's slice of each per-user f32 vector (K4: slack; K5: scale, slack
// and the five table affines). The bytes of an array that do not fill a
// 16-byte-aligned chunk (a ragged tail, or a start off 16 bytes, as
// under a row map or in a view at any offset) go by ordinary loads of the
// producer's lanes; every range lands at its global address modulo 16,
// so its 16-byte-aligned middle lands aligned, and consumers find it from
// that address (ring.cuh, landed_at). Consumers release a stage on a
// second mbarrier once every warp has taken its rows.
//
// A consumer warp takes rows warp, warp + 8, ... of each tile, two at a
// time at 8 and 16 queries. Each row's score is K1's (step1_common.cuh):
// lane l sums k = l, l+32, ... with one fmaf chain from 0.0f, the partial
// sums reduced by recursive halving, now from the staged row (two rows
// share each Qᵀ value a lane loads, each with its own chain); so a score
// is bitwise the same at every query count and from either place the row
// is read. K4 then searches the staged thresholds row in shared
// memory: for one query by warp-wide probes (16 segment ends, then the
// one segment), for several by a binary search of the whole row on every
// lane, the two searches of a query on two of its lanes. A count does not
// depend on the order of the search, so the indices are those of any
// search. K5's bucketize is arithmetic. The lookup that follows
// (divisions, exp, gathers) is most of the instructions, so it runs on
// every lane: a warp hands each (row, query) of a batch of 32 / NB rows
// to its own lane, the lanes of a tile's rows take their values out of
// the stage together (scalars, edge thresholds), and when the batch is
// full every lane computes K5's bucketize and issues its two table
// gathers; the batch finishes after the warp's next score, which the
// gathers overlap. Ragged n, d, tau and B are masked; nothing is padded.
//
// Qᵀ stays whole in shared memory up to 48 KB and streams through it in
// chunks of 256 rows beyond (d > 614 at 16 queries), the consumer warps
// synchronising between chunks on a named barrier; a chunk is a multiple
// of 32 rows, which keeps each lane's fmaf order and so every score. Each
// instance is built for a number of blocks an SM (min_blocks); the
// launcher picks the largest T (64 down to 8) whose ring of at least two
// stages fits that many, else two, else one; where K4's thresholds rows
// do not fit even so (large tau), they are searched in global memory, 512
// values at a time staged in the warp's scratch.
// Rows longer than two stages of one row each can hold (d past about
// 25,000 at f32, 50,000 at bf16) stream through the ring in chunks: a tile
// is then eight rows, one a consumer warp, and takes nch consecutive
// stages of kc values a row (kc a multiple of 256, as many as two stages
// of one block an SM hold); a warp's sums carry over the chunks, each lane
// keeping its k-set and fmaf order, so every score is the whole-row
// layout's. The per-user vectors ride the tile's last stage, and K4's
// thresholds rows are searched in global memory. Chunked and whole-row
// layouts are separate instances of the kernel.
//
// K7 (k7_bound_ranks_bf16_masked, k7_bound_ranks_int8_masked) is this
// kernel behind K6's row map. It replaces the TPU kernel
// repro/kernels/user_scores.py bound_ranks_batched_quant_masked_kernel_call:
// compact rows [e·block_n, (e+1)·block_n) read global rows from
// ids[e]·block_n on, whose per-row vectors (slack, scales, offsets,
// thr_dev) are read at the same global rows, and a compact row past n is
// written as m + 2 in all three outputs. The producer reads each tile's
// map entry and copies that entry's rows as tiles of T, so no row waits
// on a load of its id. The kept tiles of K7 are bitwise K4's / K5's
// outputs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "step1_ring.cuh"

namespace {

KernelFn resolve_quant(int kind, bool rows_f32, int nb, bool masked,
                       const Layout& L) {
  if (kind == kBf16)
    return rows_f32 ? pick<kBf16, float>(nb, masked, L)
                    : pick<kBf16, __nv_bfloat16>(nb, masked, L);
  return rows_f32 ? pick<kInt8, float>(nb, masked, L)
                  : pick<kInt8, int8_t>(nb, masked, L);
}

// K4's arguments; ids == nullptr is the identity map over n rows
int run_bf16(const void* U, int rows_f32, const float* uslack,
             const float* Q, const float* qnorm1, const void* thr,
             const void* tab, const int* ids, float* r_lo, float* r_up,
             float* est, int n, int d, int B, int tau, int ldo,
             float m_plus_1, float widen_up, float widen_lo, int rows,
             int block_n, void* stream) {
  Args a{};
  a.U = U;
  a.uslack = uslack;
  a.Q = Q;
  a.qnorm1 = qnorm1;
  a.thr = static_cast<const __nv_bfloat16*>(thr);
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
  a.c0 = widen_up;
  a.c1 = widen_lo;
  a.ids = ids;
  a.block_n = block_n;
  a.rows = rows;
  return run(a, kBf16, rows_f32, resolve_quant, stream);
}

// K5's arguments; ids == nullptr is the identity map over n rows
int run_int8(const void* U, int rows_f32, const float* uscale,
             const float* uslack, const float* Q, const float* qnorm1,
             const float* thr_sc, const float* thr_off, const float* thr_dev,
             const void* tab, const float* tab_sc, const float* tab_off,
             const int* ids, float* r_lo, float* r_up, float* est, int n,
             int d, int B, int tau, int ldo, float m_plus_1, float delta,
             float dev_pad, float widen_c, int rows, int block_n,
             void* stream) {
  Args a{};
  a.U = U;
  a.uscale = uscale;
  a.uslack = uslack;
  a.Q = Q;
  a.qnorm1 = qnorm1;
  a.tab = tab;
  a.thr_sc = thr_sc;
  a.thr_off = thr_off;
  a.thr_dev = thr_dev;
  a.tab_sc = tab_sc;
  a.tab_off = tab_off;
  a.r_lo = r_lo;
  a.r_up = r_up;
  a.est = est;
  a.n = n;
  a.d = d;
  a.B = B;
  a.tau = tau;
  a.ldo = ldo;
  a.m_plus_1 = m_plus_1;
  a.c0 = delta;
  a.c1 = dev_pad;
  a.c2 = widen_c;
  a.ids = ids;
  a.block_n = block_n;
  a.rows = rows;
  return run(a, kInt8, rows_f32, resolve_quant, stream);
}

}  // namespace

// Outputs are user-major with row stride ldo: out[user * ldo + b]. rows_f32
// != 0 takes f32 user rows (raw users against a bf16 table: the caller
// passes zero slack). The arrays may start at any address and d may be
// any length.
extern "C" int k4_bound_ranks_bf16(const void* U, int rows_f32,
                                   const float* uslack, const float* Q,
                                   const float* qnorm1, const void* thr,
                                   const void* tab, float* r_lo, float* r_up,
                                   float* est, int n, int d, int B, int tau,
                                   int ldo, float m_plus_1, float widen_up,
                                   float widen_lo, void* stream) {
  return run_bf16(U, rows_f32, uslack, Q, qnorm1, thr, tab, nullptr, r_lo,
                  r_up, est, n, d, B, tau, ldo, m_plus_1, widen_up, widen_lo,
                  n, 1, stream);
}

// rows_f32 != 0 takes f32 user rows (raw users against an int8 table: the
// caller passes unit scale and zero slack).
extern "C" int k5_bound_ranks_int8(
    const void* U, int rows_f32, const float* uscale, const float* uslack,
    const float* Q, const float* qnorm1, const float* thr_sc,
    const float* thr_off, const float* thr_dev, const void* tab,
    const float* tab_sc, const float* tab_off, float* r_lo, float* r_up,
    float* est, int n, int d, int B, int tau, int ldo, float m_plus_1,
    float delta, float dev_pad, float widen_c, void* stream) {
  return run_int8(U, rows_f32, uscale, uslack, Q, qnorm1, thr_sc, thr_off,
                  thr_dev, tab, tab_sc, tab_off, nullptr, r_lo, r_up, est, n,
                  d, B, tau, ldo, m_plus_1, delta, dev_pad, widen_c, n, 1,
                  stream);
}

// K7 at bf16: K4 over the nk tiles of block_n rows named by ids (nk,);
// outputs are compact, (nk·block_n) rows with row stride ldo.
extern "C" int k7_bound_ranks_bf16_masked(
    const void* U, int rows_f32, const float* uslack, const float* Q,
    const float* qnorm1, const void* thr, const void* tab, const int* ids,
    float* r_lo, float* r_up, float* est, int n, int d, int B, int tau,
    int ldo, float m_plus_1, float widen_up, float widen_lo, int nk,
    int block_n, void* stream) {
  return run_bf16(U, rows_f32, uslack, Q, qnorm1, thr, tab, ids, r_lo, r_up,
                  est, n, d, B, tau, ldo, m_plus_1, widen_up, widen_lo,
                  nk * block_n, block_n, stream);
}

// K7 at int8: K5 over the nk tiles of block_n rows named by ids (nk,).
extern "C" int k7_bound_ranks_int8_masked(
    const void* U, int rows_f32, const float* uscale, const float* uslack,
    const float* Q, const float* qnorm1, const float* thr_sc,
    const float* thr_off, const float* thr_dev, const void* tab,
    const float* tab_sc, const float* tab_off, const int* ids, float* r_lo,
    float* r_up, float* est, int n, int d, int B, int tau, int ldo,
    float m_plus_1, float delta, float dev_pad, float widen_c, int nk,
    int block_n, void* stream) {
  return run_int8(U, rows_f32, uscale, uslack, Q, qnorm1, thr_sc, thr_off,
                  thr_dev, tab, tab_sc, tab_off, ids, r_lo, r_up, est, n, d,
                  B, tau, ldo, m_plus_1, delta, dev_pad, widen_c,
                  nk * block_n, block_n, stream);
}

// The launch a K4 (kind 0) or K5 (kind 1) call at these sizes makes, and
// its kernel's resources (out[0..9] as step1_ring.cuh's launch_config).
extern "C" int quant_launch_config(int kind, int rows_f32, int B, int d,
                                   int tau, int masked, int* out) {
  if (kind != kBf16 && kind != kInt8) return (int)cudaErrorInvalidValue;
  return launch_config(kind, rows_f32, B, d, tau, masked, resolve_quant, out);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
