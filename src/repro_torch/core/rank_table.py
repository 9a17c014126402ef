"""Rank-table pre-processing — Algorithm 1 of the paper.

Counterpart of `repro/core/rank_table.py`, in three stages:

  1. norm pass + descending sort of P, ω partitions, s samples each;
  2. per-user threshold grids from f_min/f_max;
  3. Eq. (1) for all τ thresholds through `kernels.ops.build_table_rows`:
     on a CUDA tensor the K2 kernel, on the CPU its plain version, the
     sort + weighted suffix sum of `estimate_table_rows` (kept in
     `kernels/ref.py` beside the other plain versions).

The build always estimates in f32; the storage spec then packs the
result (`StorageSpec.pack_table`, the one pack path).

The sampling RNG cannot match `jax.random`, so the build also takes
explicit `positions`/`weights`, which the tests take from the reference.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.types import DeltaCorrection, RankTable, \
    RankTableConfig, _I8_TRANSFORM_PAD, partition_sizes
from repro_torch.kernels import ops
from repro_torch.kernels.ref import estimate_table_rows  # noqa: F401 (Eq. 1)


def stratified_sample_indices(m: int, cfg: RankTableConfig,
                              generator: Optional[torch.Generator] = None,
                              device=None
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """s item positions per norm partition (Alg. 1 lines 4-6), indexing
    the norm-descending order, and the Eq. (1) weights |P_l| / s.

    Returns positions (ω·s,) int64 and weights (ω·s,) f32.
    """
    if device is None and generator is not None:
        device = generator.device
    pos_parts, w_parts = [], []
    start = 0
    for size in partition_sizes(m, cfg.omega):
        if cfg.sample_with_replacement or cfg.s > size:
            local = torch.randint(size, (cfg.s,), generator=generator,
                                  device=device)
        else:
            local = torch.randperm(size, generator=generator,
                                   device=device)[:cfg.s]
        pos_parts.append(start + local)
        w_parts.append(torch.full((cfg.s,), size / cfg.s,
                                  dtype=torch.float32, device=device))
        start += size
    return torch.cat(pos_parts).to(torch.int64), torch.cat(w_parts)


def threshold_grid(smin: torch.Tensor, smax: torch.Tensor, tau: int
                   ) -> torch.Tensor:
    """t_{u,j} = f_min + (j-1)·(f_max - f_min)/(τ-1), j ∈ [1, τ]."""
    frac = torch.arange(tau, dtype=torch.float32,
                        device=smin.device) / (tau - 1)
    return smin[:, None] + frac[None, :] * (smax - smin)[:, None]


def _threshold_range(users: torch.Tensor,
                     items_sorted: Optional[torch.Tensor],
                     sample_scores: torch.Tensor, cfg: RankTableConfig,
                     max_norm: Optional[torch.Tensor] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """f_min / f_max per user, per cfg.threshold_mode (§4.2 + fn. 1).
    "exact" needs the items (in any order); "norm_bound" max ‖p‖, which
    is ‖items_sorted[0]‖ unless given."""
    if cfg.threshold_mode == "exact":
        full = users @ items_sorted.T                   # O(nmd): tests only
        return full.min(dim=1).values, full.max(dim=1).values
    if cfg.threshold_mode == "norm_bound":
        if max_norm is None:
            max_norm = torch.linalg.norm(items_sorted[0])   # max ‖p‖
        bound = torch.linalg.norm(users, dim=1) * max_norm
        return -bound, bound
    smin = sample_scores.min(dim=1).values
    smax = sample_scores.max(dim=1).values
    pad = cfg.range_pad * torch.clamp(smax - smin, min=1e-6)
    return smin - pad, smax + pad


def build_rank_table_sorted(users: torch.Tensor, items_sorted: torch.Tensor,
                            cfg: RankTableConfig,
                            generator: Optional[torch.Generator] = None, *,
                            positions: Optional[torch.Tensor] = None,
                            weights: Optional[torch.Tensor] = None
                            ) -> RankTable:
    """Algorithm 1 given P already sorted in descending norm order.

    Samples come from `generator`, or are given as `positions` (into the
    sorted order) and `weights`.
    """
    m = items_sorted.shape[0]
    if positions is None:
        positions, weights = stratified_sample_indices(
            m, cfg, generator, device=users.device)
    elif weights is None:
        raise ValueError("positions= needs weights= as well")
    samples = items_sorted[positions.to(users.device)].contiguous()
    weights = weights.to(device=users.device, dtype=torch.float32)
    scores = users @ samples.T                          # (n, ω·s)
    smin, smax = _threshold_range(users, items_sorted, scores, cfg)
    # Stage 3 does not take these scores: K2 computes its own, one fmaf
    # chain a score inside the kernel, so the thresholds and the
    # indicators come from two products, as in the reference. Handing it
    # this product would change the table's bits.
    del scores
    thresholds = threshold_grid(smin, smax, cfg.tau).contiguous()
    table = ops.build_table_rows(users, samples, weights, thresholds)
    return cfg.storage.pack_table(thresholds, table, m=m)


def sort_items_by_norm(items: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Alg. 1 lines 1-2: (items_sorted, order), norms descending; equal
    norms keep their input order."""
    norms = torch.linalg.norm(items.to(torch.float32), dim=1)
    order = torch.argsort(-norms, stable=True)
    return items[order], order


def build_rank_table(users: torch.Tensor, items: torch.Tensor,
                     cfg: RankTableConfig,
                     generator: Optional[torch.Generator] = None, *,
                     positions: Optional[torch.Tensor] = None,
                     weights: Optional[torch.Tensor] = None) -> RankTable:
    """Full Algorithm 1: sort by norm, partition, sample, estimate."""
    items_sorted, _ = sort_items_by_norm(items)
    return build_rank_table_sorted(users, items_sorted, cfg, generator,
                                   positions=positions, weights=weights)


# ------------------------------------------------- the mutable index
# The int8 count's half-step widening ½ + pad, rounded once to f32 as the
# reference's Python literal is.
_HALF_STEP = float(torch.tensor(0.5 + _I8_TRANSFORM_PAD,
                                dtype=torch.float32))


class SamplingArtifacts(NamedTuple):
    """The build's sampling state, kept so that a live index can be
    mutated (`repro_torch.index`): upserted users are re-estimated
    against the same stratified sample, and deleted items are matched to
    the sampled positions for the error accounting.

    samples:   (ω·s, d) sampled item vectors.
    weights:   (ω·s,) Eq. (1) stratum weights |P_l| / s.
    order:     (m,) norm-descending permutation of the items.
    positions: (ω·s,) sampled positions into the sorted order.
    max_norm:  () f32 max ‖p‖ (threshold_mode="norm_bound").
    """

    samples: torch.Tensor
    weights: torch.Tensor
    order: torch.Tensor
    positions: torch.Tensor
    max_norm: torch.Tensor


def sampling_artifacts(items: torch.Tensor, cfg: RankTableConfig,
                       generator: Optional[torch.Generator] = None, *,
                       positions: Optional[torch.Tensor] = None,
                       weights: Optional[torch.Tensor] = None
                       ) -> SamplingArtifacts:
    """The sampling state of `build_rank_table(items, cfg, ...)` with the
    same `positions`/`weights` (or drawn from `generator`, as the build
    draws them)."""
    items_sorted, order = sort_items_by_norm(items)
    if positions is None:
        positions, weights = stratified_sample_indices(
            items.shape[0], cfg, generator, device=items.device)
    elif weights is None:
        raise ValueError("positions= needs weights= as well")
    positions = positions.to(device=items.device, dtype=torch.int64)
    return SamplingArtifacts(
        samples=items_sorted[positions].contiguous(),
        weights=weights.to(device=items.device, dtype=torch.float32),
        order=order, positions=positions,
        max_norm=torch.linalg.norm(items_sorted[0].to(torch.float32)))


def recompute_user_rows(users: torch.Tensor, samples: torch.Tensor,
                        weights: torch.Tensor, cfg: RankTableConfig,
                        items: Optional[torch.Tensor] = None,
                        max_norm: Optional[torch.Tensor] = None,
                        rows: Optional[torch.Tensor] = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stages 2-3 of Algorithm 1 for the user rows `rows` of `users` (all
    rows when None), against the retained sample: the threshold range
    and grid of `build_rank_table_sorted`, and Eq. (1) through the same
    `ops.build_table_rows` (K2 on the card). Returns f32 (thresholds,
    table), each (t, τ); the caller packs them. `items` is needed for
    threshold_mode="exact", `max_norm` for "norm_bound".

    The sampled range comes from the product over all of `users`, then
    the rows: the shape of a product decides cuBLAS's algorithm, so a
    product over t rows alone can move a score's last bit against the
    build's, and with it f_min or f_max and every threshold of the row.
    Over all n rows each row's scores are those of a build over `users`
    (O(n·ω·s·d), as much as the table copy an upsert makes)."""
    users = users.to(torch.float32).contiguous()
    scores = users @ samples.T                          # (n, ω·s)
    if rows is not None:
        users, scores = users[rows].contiguous(), scores[rows]
    smin, smax = _threshold_range(users, items, scores, cfg, max_norm)
    del scores                  # K2 computes its own, as in the build
    thresholds = threshold_grid(smin, smax, cfg.tau).contiguous()
    return thresholds, ops.build_table_rows(users, samples.contiguous(),
                                            weights, thresholds)


def _count_above(sorted_scores: torch.Tensor, scores: torch.Tensor
                 ) -> torch.Tensor:
    """#{x ∈ row : x > v} per (row, query) for ascending rows (n, t) and
    scores (n, B) → (n, B) f32. −inf padding is never counted."""
    width = sorted_scores.shape[1]
    if width == 0:
        return torch.zeros(scores.shape, dtype=torch.float32,
                           device=scores.device)
    idx = torch.searchsorted(sorted_scores.contiguous(), scores.contiguous(),
                             right=True)                # #{x <= v}
    return (width - idx).to(torch.float32)


def _count_above_range(sorted_q: torch.Tensor, scale, off,
                       scores: torch.Tensor, slack
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Certified (count_lo, count_hi) of #{x_true > s_true} per (row,
    query) for score sets stored in spec space: x_true is the f32 score
    a stored entry quantized, s_true lies in scores ± slack. count_lo
    counts the entries certainly above, count_hi those possibly above.

    bf16 rows (−inf padding) compare against the monotone cast of
    s ∓ slack; int8 rows (−128 padding) against the code of
    s ∓ slack ∓ (½ + pad)·scale, clipped to [−128, 127], so a pad entry
    is never counted. The int8 constant is rounded once to f32 and the
    division is by a tensor, as in the reference run op by op."""
    width = sorted_q.shape[1]
    if width == 0:
        z = torch.zeros(scores.shape, dtype=torch.float32,
                        device=scores.device)
        return z, z
    s_lo = scores if slack is None else scores - slack
    s_hi = scores if slack is None else scores + slack
    rows = sorted_q.contiguous()

    def above(vals, side):
        return width - torch.searchsorted(rows, vals.contiguous(), side=side)

    if scale is None:                                   # bf16 storage
        st = rows.dtype
        # possibly above: x_true > s_true ⟹ bf16(x_true) ≥ bf16(s − δ)
        hi = above(s_lo.to(st), "left")
        # certainly above: bf16(x) > bf16(s + δ) ⟹ x_true > s + δ
        lo = above(s_hi.to(st), "right")
    else:                                               # int8 codes
        def code(v):
            return torch.clamp(torch.floor((v - off) / scale), -128.0,
                               127.0).to(torch.int8)

        # possibly above: x̃·sc + off + sc/2 > s − δ
        hi = above(code(s_lo - _HALF_STEP * scale), "right")
        # certainly above: x̃·sc + off − sc/2 > s + δ
        lo = above(code(s_hi + _HALF_STEP * scale), "right")
    return lo.to(torch.float32), hi.to(torch.float32)


def apply_delta_corrections(scores: torch.Tensor, r_lo: torch.Tensor,
                            r_up: torch.Tensor, est: torch.Tensor,
                            corr: DeltaCorrection,
                            slack: Optional[torch.Tensor] = None
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Fold a delta buffer into table-estimated ranks, user-major: scores,
    bounds and est are (n_rows, B) and `corr`'s rows align with them.

    The exact shift #{a ∈ A : u·a > u·q} − #{p ∈ D : u·p > u·q} moves
    base-set bounds to merged-set bounds, clipped to [1, m' + 1]; the
    estimate is shifted but not clipped, so that it stays strictly
    monotone and every backend orders it alike. Deleted users read +inf
    in all three, the one sentinel that fails every accept test and
    sorts after every live estimate, shifted ones included.

    Quantized score sets (or a score `slack`) turn the counts into
    certified ranges (`_count_above_range`): r↓ shifts by the smallest
    possible net count, r↑ by the largest, est by their midpoint. The
    f32 sets take the exact count.
    """
    quantized = (corr.add_scale is not None or corr.del_scale is not None
                 or corr.add_scores.dtype != torch.float32
                 or corr.del_scores.dtype != torch.float32
                 or slack is not None)
    if not quantized:
        shift_lo = shift_hi = shift_mid = (
            _count_above(corr.add_scores, scores)
            - _count_above(corr.del_scores, scores))
    else:
        add_lo, add_hi = _count_above_range(
            corr.add_scores, corr.add_scale, corr.add_off, scores, slack)
        del_lo, del_hi = _count_above_range(
            corr.del_scores, corr.del_scale, corr.del_off, scores, slack)
        shift_lo = add_lo - del_hi
        shift_hi = add_hi - del_lo
        shift_mid = 0.5 * (shift_lo + shift_hi)
    if isinstance(corr.m_new, torch.Tensor):
        # m_new as a 0-d f32 device tensor (the elastic program's, read at
        # replay): the same clip, min(max(x, 1), m' + 1), on its value
        top = corr.m_new + 1.0
        r_lo = torch.minimum(torch.clamp(r_lo + shift_lo, min=1.0), top)
        r_up = torch.minimum(torch.clamp(r_up + shift_hi, min=1.0), top)
    else:
        top = float(corr.m_new) + 1.0
        r_lo = torch.clamp(r_lo + shift_lo, 1.0, top)
        r_up = torch.clamp(r_up + shift_hi, 1.0, top)
    est = est + shift_mid
    dead = ~corr.user_live[:, None]
    return (torch.where(dead, torch.inf, r_lo),
            torch.where(dead, torch.inf, r_up),
            torch.where(dead, torch.inf, est))
