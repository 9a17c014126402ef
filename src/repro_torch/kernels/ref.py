"""Plain PyTorch versions of the kernels on the main path.

The CPU path of every wrapper in `ops.py` (`ref_bound_ranks`,
`ref_bound_ranks_stored`, their masked twins `ref_bound_ranks_masked`
and `ref_bound_ranks_stored_masked`, `estimate_table_rows`,
`ref_exact_counts`),
and what the tests and the chip smoke run hold each CUDA kernel against.
`ref_table_rows` computes
Eq. (1) a second way, by direct comparison, as an independent check of
K2 and of `estimate_table_rows`. Each computes the same function as its
kernel; none is a yardstick of speed.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.pruning import row_indices
from repro_torch.core.query import _dequant_matmul, lookup_bounds_batch
from repro_torch.core.types import RankTable, StoredUsers


def ref_bound_ranks(users: torch.Tensor, qs: torch.Tensor,
                    thresholds: torch.Tensor, table: torch.Tensor, m: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1's function: scores (n, B) = users·qsᵀ, then the rank-table
    lookup. Returns (r_lo, r_up, est), each (n, B) f32, user-major."""
    scores = users @ qs.T
    return lookup_bounds_batch(RankTable(thresholds, table, m), scores)


def ref_bound_ranks_stored(rows: torch.Tensor,
                           uscale: Optional[torch.Tensor],
                           uslack: torch.Tensor, qs: torch.Tensor,
                           qnorm1: torch.Tensor, rt: RankTable
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """K4's (bf16 table) and K5's (int8 table) function: scores (n, B) =
    (rows·qsᵀ)·uscale with f32 accumulate, slack = uslack·‖q‖₁ from the
    caller's `qnorm1` (B,), then the table's certified lookup
    (`query._lookup_bounds_bf16` / `_lookup_bounds_int8`). rows may be
    bf16, int8 or f32; uscale (None: no scale) and uslack are (n, 1)
    f32. Returns
    (r_lo, r_up, est), each (n, B) f32, user-major."""
    scores = _dequant_matmul(rows, uscale, qs)
    return lookup_bounds_batch(rt, scores, uslack * qnorm1[None, :])


def _masked(fn, block_ids: torch.Tensor, block_n: int, n: int, m: int
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`fn(g)` on the rows g that tiles `block_ids` of `block_n` rows
    name (clipped to n - 1), then rows past n set to m + 2 in all three
    outputs, as K6/K7 write them. Returns (nk·block_n, B) each."""
    ridx = row_indices(block_ids, block_n)
    out = fn(torch.clamp(ridx, max=n - 1))
    past = (ridx >= n)[:, None]
    fill = torch.tensor(float(m + 2), dtype=torch.float32,
                        device=ridx.device)
    return tuple(torch.where(past, fill, x) for x in out)


def ref_bound_ranks_masked(users: torch.Tensor, qs: torch.Tensor,
                           thresholds: torch.Tensor, table: torch.Tensor,
                           m: int, block_ids: torch.Tensor, block_n: int
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """K6's function: `ref_bound_ranks` on the rows of the tiles named by
    `block_ids`, compacted in list order; rows past n read m + 2."""
    def gathered(g):
        sub = RankTable(thresholds, table, m).take_rows(g)
        return ref_bound_ranks(users[g], qs, sub.thresholds, sub.table, m)
    return _masked(gathered, block_ids, block_n, users.shape[0], m)


def ref_bound_ranks_stored_masked(rows: torch.Tensor,
                                  uscale: Optional[torch.Tensor],
                                  uslack: torch.Tensor, qs: torch.Tensor,
                                  qnorm1: torch.Tensor, rt: RankTable,
                                  block_ids: torch.Tensor, block_n: int
                                  ) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """K7's function: `ref_bound_ranks_stored` on the gathered rows of
    the tiles named by `block_ids`, their per-row vectors with them;
    rows past n read m + 2."""
    def gathered(g):
        su = StoredUsers(rows, uscale, uslack).take_rows(g)
        return ref_bound_ranks_stored(su.rows, su.scale, su.row_slack, qs,
                                      qnorm1, rt.take_rows(g))
    return _masked(gathered, block_ids, block_n, rows.shape[0], rt.m)


def estimate_table_rows(scores: torch.Tensor, weights: torch.Tensor,
                        thresholds: torch.Tensor) -> torch.Tensor:
    """Eq. (1) by sort + weighted suffix sum, for (n, S) scores, (S,)
    weights and (n, τ) thresholds → (n, τ) f32 rows
    1 + Σ_s w_s·I[score_s > t_j]. Each threshold is placed by a search of
    its own, so a row may hold its thresholds in any order (ascending
    rows give non-increasing table rows)."""
    scores_sorted, order = torch.sort(scores, dim=1, stable=True)
    w_sorted = weights[order]
    suffix = torch.cat(
        [torch.flip(torch.cumsum(torch.flip(w_sorted, [1]), dim=1), [1]),
         torch.zeros_like(w_sorted[:, :1])], dim=1)
    # right=True: idx = #{scores <= t}, so the samples from idx on are
    # strictly greater than t — the indicator u·p > t of Eq. (1).
    idx = torch.searchsorted(scores_sorted, thresholds.contiguous(),
                             right=True)
    return 1.0 + torch.gather(suffix, 1, idx)


def ref_table_rows(users: torch.Tensor, samples: torch.Tensor,
                   weights: torch.Tensor, thresholds: torch.Tensor
                   ) -> torch.Tensor:
    """K2's function, Eq. (1) by direct comparison, one threshold column
    at a time so that no (n, S, τ) tensor is formed:
    T̂[i, j] = 1 + Σ_s w_s·I[u_i·p_s > t_ij]."""
    scores = users @ samples.T                          # (n, S)
    w = weights.to(torch.float32)
    out = torch.empty_like(thresholds)
    for j in range(thresholds.shape[1]):
        gt = (scores > thresholds[:, j:j + 1]).to(torch.float32)
        out[:, j] = 1.0 + gt @ w
    return out


def ref_exact_counts(users: torch.Tensor, items: torch.Tensor,
                     q: torch.Tensor, block: int = 4096) -> torch.Tensor:
    """K3's function: #{p : u·p > u·q} per user, int32. u·q comes out of
    the same product as u·p (q is appended as a row of P), so for q ∈ P
    the item equal to q never counts against itself. Users go in blocks
    so that at most (block, m+1) scores exist at once."""
    pq = torch.cat([items, q[None, :]]).T
    out = torch.empty(users.shape[0], dtype=torch.int32,
                      device=users.device)
    for start in range(0, users.shape[0], block):
        s = users[start:start + block] @ pq
        out[start:start + block] = (s[:, :-1] > s[:, -1:]).sum(
            dim=1, dtype=torch.int32)
    return out
