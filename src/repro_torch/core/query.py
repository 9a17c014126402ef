"""c-approximate reverse k-ranks query processing — §4.3 of the paper.

Counterpart of `repro/core/query.py` at f32 storage:

  1. u·q for every user + rank-table lookup → per-user (r↓, r↑, est);
  2. R↓_k / R↑_k, the Lemma-1 accept/prune masks;
  3. one composite-key selection realizes the paper's insertion order.

The primitive unit is a (B, d) query block: step 1 is one (n, d)×(d, B)
product plus one pass over the (n, τ) table for all B queries, and
`query` is the B = 1 case of `query_batch`. Selection breaks key ties
toward the lower user index, as `jax.lax.top_k` does.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import QueryResult, RankTable, kth_smallest


def _bucketize(thresholds: torch.Tensor, uq: torch.Tensor) -> torch.Tensor:
    """idx = #{j : t_j ≤ uq} per (row, query): thresholds (n, τ)
    ascending per row, uq (n, B) → (n, B) int64 in [0, τ]."""
    return torch.searchsorted(thresholds.contiguous(), uq.contiguous(),
                              right=True)


def user_scores_batch(users: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """Step-1 scores (n, B) = users (n, d) · qs (B, d)ᵀ in f32."""
    return (users @ qs.T).to(torch.float32)


def lookup_bounds_batch(rt: RankTable, uq: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rank-table lookup (§4.3 step 1) for a (n, B) score block.

    With ascending thresholds t_1..t_τ and non-increasing table T_1..T_τ:
    t_j ≤ u·q ≤ t_{j+1} ⇒ T_{j+1} ≤ r(q,u,P) ≤ T_j; u·q < t_1 gives
    (T_1, m+1) and u·q ≥ t_τ gives (1, T_τ). The estimate interpolates
    between the bracketing thresholds inside the grid, decays with the
    margin outside it, and carries the sub-unit tie-break.

    Returns (r_lo, r_up, est), each (n, B) f32.
    """
    tau = rt.tau
    thr, tab = rt.thresholds, rt.table
    idx = _bucketize(thr, uq)
    m_plus_1 = float(rt.m + 1)
    up_col = torch.clamp(idx - 1, 0, tau - 1)
    lo_col = torch.clamp(idx, 0, tau - 1)
    t_up = torch.gather(tab, 1, up_col)
    t_lo = torch.gather(tab, 1, lo_col)
    r_up = torch.where(idx == 0, m_plus_1, t_up)
    r_lo = torch.where(idx == tau, 1.0, t_lo)

    lo_thr = torch.gather(thr, 1, up_col)
    hi_thr = torch.gather(thr, 1, lo_col)
    span = torch.clamp(hi_thr - lo_thr, min=1e-12)
    frac = torch.clamp((uq - lo_thr) / span, 0.0, 1.0)
    interior = (idx > 0) & (idx < tau)
    est_in = r_up + (r_lo - r_up) * frac
    t_lo_edge = thr[:, :1]
    t_hi_edge = thr[:, tau - 1:tau]
    rng = torch.clamp(t_hi_edge - t_lo_edge, min=1e-12)
    m_above = torch.clamp(uq - t_hi_edge, min=0.0) / rng
    m_below = torch.clamp(t_lo_edge - uq, min=0.0) / rng
    est_above = 1.0 + (r_up - 1.0) / (1.0 + tau * m_above)
    est_below = m_plus_1 - (m_plus_1 - r_lo) * torch.exp(-tau * m_below)
    est = torch.where(interior, est_in,
                      torch.where(idx == tau, est_above, est_below))
    est = torch.minimum(torch.maximum(est, r_lo), r_up)
    return r_lo, r_up, est - 0.5 * m_above / (1.0 + m_above)


def bound_ranks_batch(rt: RankTable, users: torch.Tensor, qs: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense-backend step 1 for a (B, d) block → (r_lo, r_up, est), each
    (B, n), query-major."""
    r_lo, r_up, est = lookup_bounds_batch(rt, user_scores_batch(users, qs))
    return r_lo.T, r_up.T, est.T


def lemma1_key(r_lo: torch.Tensor, r_up: torch.Tensor, est: torch.Tensor, *,
               R_lo_k: torch.Tensor, R_up_k: torch.Tensor, c: float,
               m_items: int):
    """The §4.3 composite selection key (smaller = better) and the
    guaranteed/accepted/pruned masks it is built from. `m_items + 2`
    strictly dominates any est ∈ [1, m+1], separating the classes."""
    guaranteed = c * R_lo_k >= R_up_k
    accepted = r_up <= (c * R_lo_k)[..., None]              # Lemma 1 (1)
    pruned = r_lo > R_up_k[..., None]                       # Lemma 1 (2)
    prio = torch.where(accepted, 0.0, torch.where(pruned, 2.0, 1.0))
    big = float(m_items + 2)
    key = torch.where(guaranteed[..., None], est, prio * big + est)
    return key, guaranteed, accepted, pruned


def smallest_k(key: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest keys along the last axis, ties to the
    lower index (what `jax.lax.top_k` on the negated key gives)."""
    return torch.sort(key, dim=-1, stable=True).indices[..., :k]


def lemma1_select(r_lo, r_up, est, *, R_lo_k, R_up_k, k: int, c: float,
                  m_items: int):
    """§4.3 step 3 as one composite-key selection; the candidate axis is
    last. Returns (indices, guaranteed, accepted, pruned)."""
    key, guaranteed, accepted, pruned = lemma1_key(
        r_lo, r_up, est, R_lo_k=R_lo_k, R_up_k=R_up_k, c=c,
        m_items=m_items)
    return smallest_k(key, k), guaranteed, accepted, pruned


def select_topk(r_lo: torch.Tensor, r_up: torch.Tensor, est: torch.Tensor,
                *, k: int, c: float, m_items: int) -> QueryResult:
    """Steps 2-3 of §4.3 on (n,) or (B, n) bounds."""
    R_lo_k = kth_smallest(r_lo, k)
    R_up_k = kth_smallest(r_up, k)
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


def squeeze_result(res: QueryResult) -> QueryResult:
    """The B = 1 row of a batched QueryResult."""
    return QueryResult(*(x[0] for x in res))


def query(rt: RankTable, users: torch.Tensor, q: torch.Tensor, k: int,
          c: float) -> QueryResult:
    """One query: the B = 1 case of `query_batch`."""
    return squeeze_result(query_batch(rt, users, q[None, :], k, c))
