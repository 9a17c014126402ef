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

from typing import Optional

import torch

from repro_torch.core.types import RankTable, RankTableConfig, \
    partition_sizes
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


def _threshold_range(users: torch.Tensor, items_sorted: torch.Tensor,
                     sample_scores: torch.Tensor, cfg: RankTableConfig
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """f_min / f_max per user, per cfg.threshold_mode (§4.2 + fn. 1)."""
    if cfg.threshold_mode == "exact":
        full = users @ items_sorted.T                   # O(nmd): tests only
        return full.min(dim=1).values, full.max(dim=1).values
    if cfg.threshold_mode == "norm_bound":
        bound = torch.linalg.norm(users, dim=1) * torch.linalg.norm(
            items_sorted[0])                            # max ‖p‖ is row 0
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
