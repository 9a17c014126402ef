"""c-approximate reverse k-ranks query processing — §4.3 of the paper.

Counterpart of `repro/core/query.py`:

  1. u·q for every user + rank-table lookup → per-user (r↓, r↑, est);
  2. R↓_k / R↑_k, the Lemma-1 accept/prune masks;
  3. one composite-key selection realizes the paper's insertion order.

The primitive unit is a (B, d) query block: step 1 is one (n, d)×(d, B)
product plus one pass over the (n, τ) table for all B queries, and
`query` is the B = 1 case of `query_batch`. Selection breaks key ties
toward the lower user index, as `jax.lax.top_k` does.

Step 1 dispatches on the table's storage kind (`RankTable.spec_kind`):
f32 takes the exact lookup; bf16 and int8 take the certified lookups,
which fold the score slack of quantized users and their own storage
error into (r↓, r↑), r↓ rounded down and r↑ up. The f32 arithmetic is
written in the reference's operation order, so that on the same scores
the bounds are the same to the bit.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.types import EPS_BF16, DeltaCorrection, QueryResult, \
    RankTable, StoredUsers, _I8_MAX, _I8_TRANSFORM_PAD, f32_scalar, \
    kth_smallest
from repro_torch.obs import trace


def m_plus(m, offset: int):
    """m + offset as the f32 scalar of the lookup and the selection: a
    Python float for an int m, and for a 0-d f32 device tensor m (the
    elastic program writes m there before each replay, so that a change
    of m needs no new capture) a 0-d tensor on its device. The two give
    the same f32 operands, so the results are bitwise alike."""
    if isinstance(m, torch.Tensor):
        return m + float(offset)
    return float(m + offset)


def _bucketize(thresholds: torch.Tensor, uq: torch.Tensor) -> torch.Tensor:
    """idx = #{j : t_j ≤ uq} per (row, query): thresholds (n, τ)
    ascending per row, uq (n, B) → (n, B) int64 in [0, τ]."""
    return torch.searchsorted(thresholds.contiguous(), uq.contiguous(),
                              right=True)


def _dequant_matmul(rows: torch.Tensor, scale: Optional[torch.Tensor],
                    qs: torch.Tensor) -> torch.Tensor:
    """(rows·qsᵀ)·scale with rows in a storage dtype, f32 accumulate."""
    out = rows.to(torch.float32) @ qs.T.to(torch.float32)
    return out if scale is None else out * scale


def query_l1(qs: torch.Tensor) -> torch.Tensor:
    """‖q‖₁ per query, (B,) f32: the factor of every score slack.

    Summed in one fixed order that depends on d alone: |q| is padded with
    zeros to a power of two along d and halved by elementwise adds,
    x[:, :h] + x[:, h:], until one column is left. Elementwise IEEE adds
    give the same bits on the CPU and on CUDA, and for a query whatever
    the batch it comes in, so `query(q)` sees row 0's slack of
    `query_batch`. (A reduction kernel's order may depend on B.)"""
    x = qs.abs()
    width = 1 << max(x.shape[1] - 1, 0).bit_length()
    if width > x.shape[1]:
        x = torch.nn.functional.pad(x, (0, width - x.shape[1]))
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        x = x[:, :h] + x[:, h:]
    return x[:, 0].contiguous()


def user_scores_batch(users, qs: torch.Tensor
                      ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Step-1 scores for either user representation → (scores, slack),
    each (n, B).

    A raw (n, d) matrix gives (users·qsᵀ, None). `StoredUsers` rows are
    dequantized with f32 accumulation, and slack = row_slack·‖q‖₁ bounds
    |stored score − f32 score|.
    """
    if not isinstance(users, StoredUsers):
        return (users @ qs.T).to(torch.float32), None
    scores = _dequant_matmul(users.rows, users.scale, qs)
    return scores, users.row_slack * query_l1(qs)[None, :]


def _est_from_grid(uq: torch.Tensor, idx: torch.Tensor,
                   thr_up: torch.Tensor, thr_lo: torch.Tensor,
                   thr_edge_lo: torch.Tensor, thr_edge_hi: torch.Tensor,
                   r_lo: torch.Tensor, r_up: torch.Tensor, tau: int,
                   m_plus_1: float) -> torch.Tensor:
    """The §4.3 estimate on dequantized f32 grid values: interpolation
    between the thresholds bracketing `idx`, margin decay outside the
    grid, clipped to the certified [r_lo, r_up], minus the sub-unit
    tie-break. Shared by the bf16 and int8 lookups."""
    span = torch.clamp(thr_lo - thr_up, min=1e-12)
    frac = torch.clamp((uq - thr_up) / span, 0.0, 1.0)
    interior = (idx > 0) & (idx < tau)
    est_in = r_up + (r_lo - r_up) * frac
    rng = torch.clamp(thr_edge_hi - thr_edge_lo, min=1e-12)
    m_above = torch.clamp(uq - thr_edge_hi, min=0.0) / rng
    m_below = torch.clamp(thr_edge_lo - uq, min=0.0) / rng
    est_above = 1.0 + (r_up - 1.0) / (1.0 + tau * m_above)
    est_below = m_plus_1 - (m_plus_1 - r_lo) * torch.exp(-tau * m_below)
    est = torch.where(interior, est_in,
                      torch.where(idx == tau, est_above, est_below))
    est = torch.minimum(torch.maximum(est, r_lo), r_up)
    return est - 0.5 * m_above / (1.0 + m_above)


def bf16_indices(rt: RankTable, uq: torch.Tensor,
                 slack: Optional[torch.Tensor]
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(idx_lo, idx_hi) of the bf16 lookup: with t̃ = bf16(t),
    idx_hi = #{t̃ ≤ bf16(s+δ)} ≥ idx* and idx_lo = #{t̃ < bf16(s−δ)} ≤ idx*
    (the cast is monotone and rounds to nearest even)."""
    thr = rt.thresholds
    s_hi = uq if slack is None else uq + slack
    s_lo = uq if slack is None else uq - slack
    idx_hi = torch.searchsorted(thr, s_hi.to(thr.dtype).contiguous(),
                                side="right")
    idx_lo = torch.searchsorted(thr, s_lo.to(thr.dtype).contiguous(),
                                side="left")
    return idx_lo, idx_hi


def bf16_bounds(rt: RankTable, idx_lo: torch.Tensor, idx_hi: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(r_lo, r_up) of the bf16 lookup at given indices: table reads
    widened by EPS_BF16 in the certified direction, r↑ = T̃[idx_lo−1]·(1+ε)
    (m+1 at idx_lo = 0) and r↓ = T̃[idx_hi]·(1−ε) (1 at idx_hi = τ)."""
    tau = rt.tau
    up_col = torch.clamp(idx_lo - 1, 0, tau - 1)
    lo_col = torch.clamp(idx_hi, 0, tau - 1)
    t_up = torch.gather(rt.table, 1, up_col).to(torch.float32)
    t_lo = torch.gather(rt.table, 1, lo_col).to(torch.float32)
    r_up = torch.where(idx_lo == 0, m_plus(rt.m, 1), t_up * (1.0 + EPS_BF16))
    r_lo = torch.where(idx_hi == tau, 1.0, t_lo * (1.0 - EPS_BF16))
    return r_lo, r_up


def _lookup_bounds_bf16(rt: RankTable, uq: torch.Tensor,
                        slack: Optional[torch.Tensor]
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Certified lookup on a bf16 table: `bf16_indices`, `bf16_bounds`,
    and the estimate between the bf16 thresholds around idx_hi."""
    tau = rt.tau
    thr = rt.thresholds
    idx_lo, idx_hi = bf16_indices(rt, uq, slack)
    r_lo, r_up = bf16_bounds(rt, idx_lo, idx_hi)

    def thr32(col):
        return torch.gather(thr, 1, col).to(torch.float32)

    est = _est_from_grid(
        uq, idx_hi, thr32(torch.clamp(idx_hi - 1, 0, tau - 1)),
        thr32(torch.clamp(idx_hi, 0, tau - 1)), thr[:, :1].to(torch.float32),
        thr[:, tau - 1:tau].to(torch.float32), r_lo, r_up, tau,
        m_plus(rt.m, 1))
    return r_lo, r_up, est


def int8_constants(tau: int) -> tuple[float, float, float]:
    """The int8 lookup's constants, each rounded once from double to f32
    as the reference's Python literals are: the code step Δ = 254/(τ−1),
    the bucketize pad 20·_I8_TRANSFORM_PAD and the table widening factor
    ½ + _I8_TRANSFORM_PAD."""
    f32 = lambda x: float(torch.tensor(x, dtype=torch.float32))
    return (f32(2.0 * _I8_MAX / (tau - 1)), f32(20.0 * _I8_TRANSFORM_PAD),
            f32(0.5 + _I8_TRANSFORM_PAD))


def int8_indices(rt: RankTable, uq: torch.Tensor,
                 slack: Optional[torch.Tensor]
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(idx_lo, idx_hi) of the int8 lookup, in closed form: the f32
    thresholds sit within thr_dev of the code grid G_j = −127 + jΔ, so
    with s' = (s − off)/sc, δ' = slack/sc and dev' = thr_dev + pad,
    idx = clip(⌊(v + 127)/Δ⌋, −1, τ) + 1 at v = (s' ± δ') ± dev'. The
    thresholds are never read."""
    tau = rt.tau
    delta, dev_pad, _ = int8_constants(tau)
    sc_t, off_t = rt.thr_scale, rt.thr_off
    s_n = (uq - off_t) / sc_t
    d_n = 0.0 if slack is None else slack / sc_t
    dev = rt.thr_dev + dev_pad
    step = f32_scalar(delta, uq)

    def count(v):
        return torch.clamp(torch.floor((v + 127.0) / step), -1.0,
                           float(tau)).to(torch.int32) + 1

    idx_hi = torch.clamp(count(s_n + d_n + dev), 0, tau).to(torch.int64)
    idx_lo = torch.clamp(count(s_n - d_n - dev), 0, tau).to(torch.int64)
    return idx_lo, idx_hi


def int8_bounds(rt: RankTable, idx_lo: torch.Tensor, idx_hi: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(r_lo, r_up) of the int8 lookup at given indices: table codes
    dequantize per row as code·sc + off and widen by (½ + pad)·sc, r↓
    down and r↑ up (m+1 at idx_lo = 0, 1 at idx_hi = τ)."""
    tau = rt.tau
    _, _, widen_c = int8_constants(tau)
    sc_b, off_b = rt.tab_scale, rt.tab_off

    def deq_tab(col):
        return torch.gather(rt.table, 1, col).to(torch.float32) * sc_b + off_b

    widen = widen_c * sc_b
    r_up = torch.where(idx_lo == 0, m_plus(rt.m, 1),
                       deq_tab(torch.clamp(idx_lo - 1, 0, tau - 1)) + widen)
    r_lo = torch.where(idx_hi == tau, 1.0,
                       deq_tab(torch.clamp(idx_hi, 0, tau - 1)) - widen)
    return r_lo, r_up


def _lookup_bounds_int8(rt: RankTable, uq: torch.Tensor,
                        slack: Optional[torch.Tensor]
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Certified lookup on an int8 table: `int8_indices`, `int8_bounds`,
    and the estimate on the code grid in closed form (G_c·sc + off)."""
    tau = rt.tau
    delta, _, _ = int8_constants(tau)
    sc_t, off_t = rt.thr_scale, rt.thr_off
    idx_lo, idx_hi = int8_indices(rt, uq, slack)
    r_lo, r_up = int8_bounds(rt, idx_lo, idx_hi)

    def grid_at(col):
        return (col.to(torch.float32) * delta - 127.0) * sc_t + off_t

    est = _est_from_grid(
        uq, idx_hi, grid_at(torch.clamp(idx_hi - 1, 0, tau - 1)),
        grid_at(torch.clamp(idx_hi, 0, tau - 1)), -127.0 * sc_t + off_t,
        127.0 * sc_t + off_t, r_lo, r_up, tau, m_plus(rt.m, 1))
    return r_lo, r_up, est


def lookup_bounds_batch(rt: RankTable, uq: torch.Tensor,
                        slack: Optional[torch.Tensor] = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rank-table lookup (§4.3 step 1) for a (n, B) score block,
    dispatched on the table's storage kind. `slack` (n, B) is the score
    error bound of quantized users, folded into a quantized table's
    bounds; an f32 table takes none.

    With ascending thresholds t_1..t_τ and non-increasing table T_1..T_τ:
    t_j ≤ u·q ≤ t_{j+1} ⇒ T_{j+1} ≤ r(q,u,P) ≤ T_j; u·q < t_1 gives
    (T_1, m+1) and u·q ≥ t_τ gives (1, T_τ). The estimate interpolates
    between the bracketing thresholds inside the grid, decays with the
    margin outside it, and carries the sub-unit tie-break.

    Returns (r_lo, r_up, est), each (n, B) f32.
    """
    kind = rt.spec_kind
    if kind == "int8":
        return _lookup_bounds_int8(rt, uq, slack)
    if kind == "bf16":
        return _lookup_bounds_bf16(rt, uq, slack)
    if slack is not None:
        raise ValueError("score slack requires a quantized rank table "
                         "(an exact f32 table cannot widen its bounds)")
    tau = rt.tau
    thr, tab = rt.thresholds, rt.table
    idx = _bucketize(thr, uq)
    m_plus_1 = m_plus(rt.m, 1)
    up_col = torch.clamp(idx - 1, 0, tau - 1)
    lo_col = torch.clamp(idx, 0, tau - 1)
    t_up = torch.gather(tab, 1, up_col)
    t_lo = torch.gather(tab, 1, lo_col)
    r_up = torch.where(idx == 0, m_plus_1, t_up)
    r_lo = torch.where(idx == tau, 1.0, t_lo)
    return r_lo, r_up, _est_from_grid(
        uq, idx, torch.gather(thr, 1, up_col), torch.gather(thr, 1, lo_col),
        thr[:, :1], thr[:, tau - 1:tau], r_lo, r_up, tau, m_plus_1)


def bound_ranks_batch(rt: RankTable, users, qs: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense-backend step 1 for a (B, d) block → (r_lo, r_up, est), each
    (B, n), query-major. `users` is a raw (n, d) tensor or `StoredUsers`.
    """
    r_lo, r_up, est = lookup_bounds_batch(rt, *user_scores_batch(users, qs))
    return r_lo.T, r_up.T, est.T


def lemma1_key(r_lo: torch.Tensor, r_up: torch.Tensor, est: torch.Tensor, *,
               R_lo_k: torch.Tensor, R_up_k: torch.Tensor, c, m_items):
    """The §4.3 composite selection key (smaller = better) and the
    guaranteed/accepted/pruned masks it is built from. `m_items + 2`
    strictly dominates any est ∈ [1, m+1], separating the classes.

    `c` and `m_items` are Python numbers, or 0-d f32 tensors on the
    bounds' device (the elastic program's, read at replay); either way c
    enters as its f32 value, so the keys are bitwise alike."""
    guaranteed = c * R_lo_k >= R_up_k
    accepted = r_up <= (c * R_lo_k)[..., None]              # Lemma 1 (1)
    pruned = r_lo > R_up_k[..., None]                       # Lemma 1 (2)
    prio = torch.where(accepted, 0.0, torch.where(pruned, 2.0, 1.0))
    big = m_plus(m_items, 2)
    key = torch.where(guaranteed[..., None], est, prio * big + est)
    return key, guaranteed, accepted, pruned


def smallest_k(key: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest keys along the last axis, ties to the
    lower index (what `jax.lax.top_k` on the negated key gives)."""
    return torch.sort(key, dim=-1, stable=True).indices[..., :k]


def lemma1_select(r_lo, r_up, est, *, R_lo_k, R_up_k, k: int, c,
                  m_items):
    """§4.3 step 3 as one composite-key selection; the candidate axis is
    last. Returns (indices, guaranteed, accepted, pruned)."""
    key, guaranteed, accepted, pruned = lemma1_key(
        r_lo, r_up, est, R_lo_k=R_lo_k, R_up_k=R_up_k, c=c,
        m_items=m_items)
    return smallest_k(key, k), guaranteed, accepted, pruned


def select_topk(r_lo: torch.Tensor, r_up: torch.Tensor, est: torch.Tensor,
                *, k: int, c, m_items) -> QueryResult:
    """Steps 2-3 of §4.3 on (n,) or (B, n) bounds. `c` and `m_items`
    may be 0-d f32 device tensors (`lemma1_key`); nothing here reads a
    value back to the host. Spans: `query.select` around it all,
    `select.kth` (the two order statistics) and `select.lemma1` (the key
    and its sort) inside it."""
    with trace.span("query.select"):
        with trace.span("select.kth"):
            R_lo_k = kth_smallest(r_lo, k)
            R_up_k = kth_smallest(r_up, k)
        with trace.span("select.lemma1"):
            indices, guaranteed, accepted, pruned = lemma1_select(
                r_lo, r_up, est, R_lo_k=R_lo_k, R_up_k=R_up_k, k=k, c=c,
                m_items=m_items)
        return QueryResult(
            indices=indices,
            est_rank=torch.gather(est, -1, indices),
            r_lo=r_lo, r_up=r_up, R_lo_k=R_lo_k, R_up_k=R_up_k,
            guaranteed=guaranteed,
            n_accepted=accepted.sum(dim=-1, dtype=torch.int32),
            n_pruned=pruned.sum(dim=-1, dtype=torch.int32))


def query_batch(rt: RankTable, users: torch.Tensor, qs: torch.Tensor,
                k: int, c: float) -> QueryResult:
    """Batched c-approximate reverse k-ranks queries on the dense path;
    qs is (B, d) and every field gains a leading B axis."""
    r_lo, r_up, est = bound_ranks_batch(rt, users, qs)
    return select_topk(r_lo, r_up, est, k=k, c=c, m_items=rt.m)


def _delta_bounds_batch(rt: RankTable, users, qs: torch.Tensor,
                        corr: DeltaCorrection
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Step 1 plus the delta correction for a (B, d) block → corrected
    (r_lo, r_up, est), each (B, n). The correction reuses step 1's scores
    and slack."""
    from repro_torch.core.rank_table import apply_delta_corrections
    scores, slack = user_scores_batch(users, qs)            # (n, B)
    r_lo, r_up, est = lookup_bounds_batch(rt, scores, slack)
    r_lo, r_up, est = apply_delta_corrections(scores, r_lo, r_up, est, corr,
                                              slack=slack)
    return r_lo.T, r_up.T, est.T


def query_batch_delta(rt: RankTable, users, qs: torch.Tensor,
                      corr: DeltaCorrection, k: int, c: float
                      ) -> QueryResult:
    """`query_batch` over a mutated index: step 1, the delta correction
    (`rank_table.apply_delta_corrections`), then the selection with the
    delta-widened class offset `corr.selection_m()`."""
    r_lo, r_up, est = _delta_bounds_batch(rt, users, qs, corr)
    return select_topk(r_lo, r_up, est, k=k, c=c,
                       m_items=corr.selection_m())


def squeeze_result(res: QueryResult) -> QueryResult:
    """The B = 1 row of a batched QueryResult."""
    return QueryResult(*(x[0] for x in res))


def query(rt: RankTable, users: torch.Tensor, q: torch.Tensor, k: int,
          c: float) -> QueryResult:
    """One query: the B = 1 case of `query_batch`."""
    return squeeze_result(query_batch(rt, users, q[None, :], k, c))
