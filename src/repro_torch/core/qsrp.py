"""QSRP baseline (Bian et al., ICDE'24), extended to c-approximate queries.

Counterpart of `repro/core/qsrp.py`, the paper's comparison target:

  * OFFLINE: the inner products of ALL user-item pairs (Ω(nmd), the cost
    the paper criticizes), each user's list sorted descending and kept at
    `levels` rank-quantile positions. With `levels = 2τ` the summary
    takes the rank table's memory (thresholds + table). It runs in
    chunks of users, so the (n, m) matrix never exists whole (8.5·10⁹
    scores at Netflix size); the product and the sort are library calls,
    as the reference computes both in jnp outside any Pallas kernel.
  * ONLINE: a search of the summary gives exact rank bounds of width at
    most m/levels; Lemma 1 filters; every user left undetermined is
    resolved by an exact scan of P (`core.exact.exact_ranks`: K3 on the
    card, its plain version on the CPU). Accuracy is always 1 (§5.3) and
    the worst-case online time O(nmd).

The reference pads the refinement's candidates to power-of-two buckets to
bound XLA recompiles; nothing here compiles per shape, so the candidates
go as they are, with the same results. Ties in the final order go to the
lower user index.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.exact import exact_ranks
from repro_torch.core.types import kth_smallest


class QSRPIndex(NamedTuple):
    """Per-user rank-quantile summary of the full inner-product matrix.

    quantile_scores: (n, levels) f32, u_i's inner products at the rank
      positions `ranks_at` of its descending-sorted list of {u_i·p}.
    ranks_at: (levels,) int32, the rank positions (1-indexed, ascending).
    m: |P| as a Python int.
    """

    quantile_scores: torch.Tensor
    ranks_at: torch.Tensor
    m: int


def _columns(m: int, levels: int, device) -> torch.Tensor:
    """The columns of the descending list that the summary keeps,
    round(j·(m−1)/(levels−1)) for j < levels, computed as the reference's
    `jit` computes them: the int32 product converted to f32, times the
    f32 reciprocal of levels − 1 (XLA turns a division by a constant into
    that product, which differs from the IEEE quotient at some sizes,
    e.g. m = 99,999, levels = 2,000), rounded half to even."""
    j = torch.arange(levels, dtype=torch.int32, device=device) * (m - 1)
    recip = float(np.float32(1.0) / np.float32(levels - 1))
    return torch.round(j.to(torch.float32) * recip).to(torch.int64)


def build_qsrp_index(users: torch.Tensor, items: torch.Tensor,
                     levels: int = 1000, block: int = 1024) -> QSRPIndex:
    """The Ω(nmd) pre-processing pass, `block` users at a time: their
    (block, m) products, a descending sort of each row, the kept columns.
    `ranks_at` is computed on the host in double, as the reference's is."""
    n, m = users.shape[0], items.shape[0]
    cols = _columns(m, levels, users.device)
    out = torch.empty((n, levels), dtype=torch.float32, device=users.device)
    items_t = items.T
    for s in range(0, n, block):
        ips = users[s:s + block] @ items_t                  # (blk, m)
        srt = torch.sort(ips, dim=1, descending=True).values
        del ips
        out[s:s + block] = srt[:, cols]
        del srt
    pos = np.round(np.arange(levels) * (m - 1) / (levels - 1)).astype(
        np.int32)
    return QSRPIndex(quantile_scores=out,
                     ranks_at=torch.from_numpy(pos + 1).to(users.device),
                     m=int(m))


# Users a step of the summary's search: the ascending copy of their rows
# it makes is 256 MB at levels = 1,000, not the index's 1.92 GB.
_SEARCH_BLOCK = 65_536


def _bounds_from_summary(idx: QSRPIndex, uq: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact rank bounds from the quantile summary, (n,) f32 each.

    Rows are descending (rank position ascending): if scores[j] > u·q ≥
    scores[j+1], the rank lies in (ranks_at[j], ranks_at[j+1]]; the
    summary holds true order statistics, so the bounds are exact. Rows
    are flipped ascending `_SEARCH_BLOCK` users at a time for the search."""
    desc = idx.quantile_scores
    levels = desc.shape[1]
    gt = torch.empty(desc.shape[0], dtype=torch.int64, device=desc.device)
    for s in range(0, desc.shape[0], _SEARCH_BLOCK):
        e = s + _SEARCH_BLOCK
        gt[s:e] = torch.searchsorted(desc[s:e].flip(1),
                                     uq[s:e, None].contiguous(),
                                     side="left")[:, 0]
    j = levels - gt                                         # in [0, levels]
    ranks = idx.ranks_at.to(torch.float32)
    r_lo = torch.where(j == 0, 1.0, ranks[torch.clamp(j - 1, 0, levels - 1)])
    r_up = torch.where(j == levels, float(idx.m + 1),
                       ranks[torch.clamp(j, 0, levels - 1)])
    return r_lo, r_up


def qsrp_query(idx: QSRPIndex, users: torch.Tensor, items: torch.Tensor,
               q: torch.Tensor, k: int, c: float
               ) -> tuple[np.ndarray, np.ndarray, int]:
    """c-approximate reverse k-ranks with QSRP semantics (accuracy 1).

    Returns (indices int32, ranks, n_refined): the selected users, their
    EXACT ranks, and how many users took the refinement scan."""
    uq = (users @ q).to(torch.float32)
    r_lo, r_up = _bounds_from_summary(idx, uq)
    R_lo_k = kth_smallest(r_lo, k)
    R_up_k = kth_smallest(r_up, k)
    accepted = (r_up <= c * R_lo_k).cpu().numpy()
    pruned = (r_lo > R_up_k).cpu().numpy()
    r_up_np = r_up.cpu().numpy()

    accepted_idx = np.flatnonzero(accepted)
    if len(accepted_idx) >= k:
        # Lemma 1 (1): every accepted user is admissible, no refinement;
        # by the exact upper bound, ties to the lower index
        order = accepted_idx[np.lexsort(
            (accepted_idx, r_up_np[accepted_idx]))][:k]
        sel = torch.from_numpy(order).to(users.device)
        ranks = exact_ranks(users[sel].contiguous(), items, q)
        return order.astype(np.int32), \
            ranks.cpu().numpy().astype(np.float32), 0

    # too few guaranteed users: every undetermined one takes an exact
    # O(md) scan, the O(nmd) worst case the paper criticizes
    cand = np.flatnonzero(~pruned)
    keys = np.full(users.shape[0], np.inf, dtype=np.float64)
    if len(cand):
        sel = torch.from_numpy(cand).to(users.device)
        keys[cand] = exact_ranks(users[sel].contiguous(), items,
                                 q).cpu().numpy()
    order = np.lexsort((np.arange(len(keys)), keys))[:k]
    return order.astype(np.int32), keys[order], int(len(cand))
