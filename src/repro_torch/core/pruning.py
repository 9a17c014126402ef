"""Block-summary pruning: the two-phase coarse-to-fine §4.3 scan.

Counterpart of `repro/core/pruning.py` for the static index. A user with
r↓ > R↑_k can never enter the answer set (Lemma 1); this module lifts
that test from users to blocks of `block_size` consecutive users, so
that whole tiles are skipped before their bytes are read:

  build time  `build_block_summary` folds each block into a sketch:
              per-dimension coordinate extremes (a box around the
              block's user vectors), column-wise envelopes of its
              threshold and table rows, and a norm band and angular
              cone around its members;
  phase A     `phase_a` scores every block against the (B, d) query
              block: the sketches give a certified score range per
              (block, query), the envelopes turn it into a lower bound
              on every member's r↓ and an upper bound on every member's
              r↑; sorting blocks by that r↑ bound and accumulating live
              rows to k seeds R̂ ≥ R↑_k, and a block is kept iff its r↓
              bound ≤ R̂;
  phase B     step 1 runs over the kept blocks only (a gathered product
              on the dense path, K6/K7 on the fused path), with rows in
              compacted block-list order; skipped users read the
              dominated sentinel m + 2, so the selection returns the
              full scan's indices bit for bit.

Why the selection stays exact, and how f32 rounding is certified (every
score range widened by a slack that covers any summation order, every
cosine and norm widened in the direction that can only loosen a bound),
is set out in the reference's module docstring; this module computes
the same quantities in the same operation order.

`kmeans_layout` clusters the user matrix at build time and returns the
row order that makes blocks tight (`ReverseKRanksEngine.build(...,
cluster_reorder=True)`).

On a mutated index (`repro_torch.index`) phase A widens the envelopes
by the padded delta widths and leaves deleted users out of R̂'s live
counts, and phase B folds the delta correction into the kept rows
(`pruned_query_batch_delta`, `delta_finish_compacted`).

`PruneStats.publish` mirrors a batch's accounting into the metrics
registry (`prune_skip_rate`, `prune_kept_per_query`,
`prune_batches_total{fallback=...}`); `PrunedBackend` calls it after
every batch.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.query import _bucketize, lemma1_select, \
    lookup_bounds_batch, query_l1, user_scores_batch
from repro_torch.core.types import EPS_BF16, DeltaCorrection, QueryResult, \
    RankTable, StoredUsers, _I8_TRANSFORM_PAD, kth_smallest, take_user_rows

# Summary block size, the tile that a block id names in K6/K7.
DEFAULT_BLOCK = 256

# Delta share of the base items, (n_add + n_del) / m at the padded
# widths, above which a pruned query skips phase A and runs the inner
# backend's full scan (`PruneStats.fallback = "delta-guard"`).
DELTA_GUARD = 0.25

# Relative widening of a certified score range per unit of dimension:
# f32 dot-product rounding is bounded by ~d·2^-24 of Σ|u_j·q_j|; 4e-7·d
# covers it with a 6x margin, the absolute term guards all-zero rows.
_SCORE_SLACK = 4e-7
_SCORE_SLACK_ABS = 1e-6

# Absolute floor of the unit-vector dot slack of the cone sketches.
_COS_SLACK_ABS = 1e-6


def _cos_slack(d: int) -> float:
    """f32 rounding slack for a dot product of two unit vectors of
    dimension d."""
    return _SCORE_SLACK * d + _COS_SLACK_ABS


class BlockSummary(NamedTuple):
    """Per-block sketch of the user matrix and rank table.

    dim_min/dim_max: (nb, d) f32 coordinate extremes of the members.
    thr_min/thr_max: (nb, τ) column-wise envelope of the threshold rows
                     (f32; certified-widened at a quantized spec).
    tab_min/tab_max: (nb, τ) column-wise envelope of the table rows.
    rows:            (nb,) int32 real rows per block (the tail block of a
                     non-multiple n is partial).
    m:               |P| as a Python int.
    user_slack:      (nb, 1) f32, the largest row slack in the block
                     (quantized user rows), else None.
    score_eps:       () f32, set on a quantized table's summary (bf16:
                     EPS_BF16, int8: 0), else None.
    norm_min/norm_max: (nb, 1) f32 band around every member's ‖u‖₂.
    mu:              (nb, d) f32 unit mean direction (exact 0 rows where
                     the directions cancel).
    cos_r:           (nb, 1) f32 lower bound on û·μ̂ over members.
    The last four are None when built with with_cones=False.
    """

    dim_min: torch.Tensor
    dim_max: torch.Tensor
    thr_min: torch.Tensor
    thr_max: torch.Tensor
    tab_min: torch.Tensor
    tab_max: torch.Tensor
    rows: torch.Tensor
    m: int
    user_slack: Optional[torch.Tensor] = None
    score_eps: Optional[torch.Tensor] = None
    norm_min: Optional[torch.Tensor] = None
    norm_max: Optional[torch.Tensor] = None
    mu: Optional[torch.Tensor] = None
    cos_r: Optional[torch.Tensor] = None

    @property
    def n_blocks(self) -> int:
        return self.dim_min.shape[0]

    @property
    def tau(self) -> int:
        return self.thr_min.shape[1]


@dataclasses.dataclass
class PruneStats:
    """Skip-rate accounting for one pruned `query_batch` call."""

    n_blocks: int = 0            # summary blocks in the index
    kept_union: int = 0          # blocks phase B executed (union over B)
    kept_per_query: float = 0.0  # mean per-query kept fraction
    fallback: str = ""           # "" (pruned), "dense" (union too big)
    # or "delta-guard" (delta too large to prune)

    @property
    def union_fraction(self) -> float:
        return self.kept_union / max(self.n_blocks, 1)

    @property
    def skip_rate(self) -> float:
        return 1.0 - self.union_fraction

    def publish(self, registry=None) -> None:
        """Mirror this batch's accounting into metrics gauges (the live
        half of the bench's §6.3 prune columns): `prune_skip_rate`,
        `prune_kept_per_query`, and per-reason fallback counters."""
        from repro_torch.obs import registry as obs
        reg = registry if registry is not None else obs.get_default()
        reg.gauge("prune_skip_rate",
                  "1 - kept-union fraction of the last pruned batch"
                  ).set(self.skip_rate)
        reg.gauge("prune_kept_per_query",
                  "mean per-query kept-block fraction, last batch"
                  ).set(self.kept_per_query)
        reg.counter("prune_batches_total",
                    "pruned query_batch calls",
                    labels={"fallback": self.fallback or "none"}).inc()


def _per_block(x: torch.Tensor, block_size: int, op: str) -> torch.Tensor:
    """`op` ("amin", "amax" or "sum") over each block of `block_size`
    rows of x (n, ...) → (nb, ...). The tail block reduces its real rows
    only, which is what padding with the op's identity gives."""
    n = x.shape[0]
    full = n // block_size
    parts = []
    if full:
        head = x[:full * block_size].reshape(full, block_size, *x.shape[1:])
        parts.append(getattr(head, op)(dim=1))
    if n % block_size:
        parts.append(getattr(x[full * block_size:], op)(dim=0)[None])
    return torch.cat(parts)


def build_block_summary(users, rt: RankTable,
                        block_size: int = DEFAULT_BLOCK,
                        with_cones: bool = True) -> BlockSummary:
    """Fold (users, rank table) into per-block sketches, one pass over
    the index.

    On an f32 index the envelopes are min/max of the stored values, so
    phase A compares against exactly what the per-user lookup reads. On
    a bf16 or int8 index each stored row is first widened to the f32
    interval that provably holds its true values (± EPS_BF16 relative
    for bf16 table entries, ± (½ + pad) code steps for int8), so the
    envelopes bracket every member's certified (r↓, r↑). `users` is a
    raw (n, d) tensor or `StoredUsers` (dequantized for the sketches;
    its row slack widens phase A's score range).
    """
    if isinstance(users, StoredUsers):
        u32 = users.rows.to(torch.float32)
        if users.scale is not None:
            u32 = u32 * users.scale
        slack_rows = users.row_slack
    else:
        u32 = users.to(torch.float32)
        slack_rows = None
    n, d = u32.shape
    nb = -(-n // block_size)
    kind = rt.spec_kind
    user_slack = score_eps = None
    if kind == "f32":
        if slack_rows is not None:
            raise ValueError("quantized user storage requires a quantized "
                             "rank table (uniform StorageSpec)")
        thr_lo_rows = thr_hi_rows = rt.thresholds
        tab_lo_rows = tab_hi_rows = rt.table
    elif kind == "bf16":
        thr_lo_rows = thr_hi_rows = rt.thresholds.to(torch.float32)
        tab32 = rt.table.to(torch.float32)
        tab_lo_rows = tab32 * (1.0 - EPS_BF16)
        tab_hi_rows = tab32 * (1.0 + EPS_BF16)
        score_eps = torch.tensor(EPS_BF16, dtype=torch.float32,
                                 device=u32.device)
    else:                                       # int8 per-row affine codes
        half = 0.5 + _I8_TRANSFORM_PAD
        thr32 = rt.thresholds.to(torch.float32) * rt.thr_scale + rt.thr_off
        tab32 = rt.table.to(torch.float32) * rt.tab_scale + rt.tab_off
        thr_lo_rows = thr32 - half * rt.thr_scale
        thr_hi_rows = thr32 + half * rt.thr_scale
        tab_lo_rows = tab32 - half * rt.tab_scale
        tab_hi_rows = tab32 + half * rt.tab_scale
        score_eps = torch.tensor(0.0, dtype=torch.float32, device=u32.device)
    if kind != "f32" and slack_rows is not None:
        user_slack = _per_block(slack_rows.to(torch.float32), block_size,
                                "amax")
    starts = torch.arange(nb, device=u32.device, dtype=torch.int64) \
        * block_size
    rows = torch.clamp(n - starts, max=block_size).to(torch.int32)
    norm_min = norm_max = mu = cos_r = None
    if with_cones:
        cs = _cos_slack(d)
        norms = torch.sqrt(torch.sum(u32 * u32, dim=1))     # (n,)
        # band widened for the sum-of-squares + sqrt rounding; zero rows
        # keep n↓ = 0 exactly (their score 0 must stay bracketed)
        norm_min = _per_block((norms * (1.0 - cs))[:, None], block_size,
                              "amin")
        norm_max = _per_block((norms * (1.0 + cs))[:, None], block_size,
                              "amax")
        # unit directions; exact-zero rows map to the zero direction
        uhat = u32 / torch.clamp(norms, min=1e-30)[:, None]
        mu_raw = _per_block(uhat, block_size, "sum")         # (nb, d)
        mu_n = torch.sqrt(torch.sum(mu_raw * mu_raw, dim=1, keepdim=True))
        # a cancelled mean direction is stored as exactly 0: the query
        # side then sees cosθ = 0 and cos_r < 0, the vacuous cone
        mu = torch.where(mu_n > 1e-20,
                         mu_raw / torch.clamp(mu_n, min=1e-30), 0.0)
        blk_of = torch.arange(n, device=u32.device) // block_size
        dots = torch.sum(uhat * mu[blk_of], dim=1)           # (n,)
        cos_r = torch.clamp(_per_block(dots[:, None], block_size, "amin")
                            - cs, -1.0, 1.0)
    return BlockSummary(
        dim_min=_per_block(u32, block_size, "amin"),
        dim_max=_per_block(u32, block_size, "amax"),
        thr_min=_per_block(thr_lo_rows, block_size, "amin"),
        thr_max=_per_block(thr_hi_rows, block_size, "amax"),
        tab_min=_per_block(tab_lo_rows, block_size, "amin"),
        tab_max=_per_block(tab_hi_rows, block_size, "amax"),
        rows=rows, m=int(rt.m), user_slack=user_slack,
        score_eps=score_eps, norm_min=norm_min, norm_max=norm_max, mu=mu,
        cos_r=cos_r)


def _kmeans_step(u: torch.Tensor, centers: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd iteration: assign rows to the nearest center (expanded
    ‖u − c‖² = ‖u‖² − 2u·c + ‖c‖², first minimum on ties), then recenter;
    an empty cluster keeps its old center. The cluster sums are a product
    with the one-hot assignment, deterministic on the card (an index_add
    there sums by atomics, in no fixed order)."""
    K = centers.shape[0]
    d2 = (torch.sum(u * u, dim=1, keepdim=True)
          - 2.0 * (u @ centers.T)
          + torch.sum(centers * centers, dim=1)[None, :])
    assign = torch.argmin(d2, dim=1)
    onehot = torch.zeros((u.shape[0], K), dtype=torch.float32,
                         device=u.device).scatter_(1, assign[:, None], 1.0)
    sums = onehot.T @ u
    counts = onehot.sum(dim=0)
    new = torch.where(counts[:, None] > 0.0,
                      sums / torch.clamp(counts, min=1.0)[:, None], centers)
    return assign, new


def kmeans_layout(users: torch.Tensor, *, block_size: int = DEFAULT_BLOCK,
                  n_clusters: Optional[int] = None, iters: int = 8,
                  init_rows: Optional[torch.Tensor] = None
                  ) -> Optional[torch.Tensor]:
    """Build-time row layout that makes summary blocks tight.

    K-means-clusters the f32 user matrix and returns the permutation
    `perm[new] = old` (int64, on the users' device) that groups each
    cluster into consecutive rows, ordered within a cluster by distance
    to its center and then by row id (the order `np.lexsort` gives the
    reference). Returns None when the matrix spans fewer than two blocks.

    The initial centers are the rows `init_rows` ((K,) indices; the
    reference draws them with `jax.random.choice`), else K distinct rows
    drawn by a generator seeded 0 on the users' device, so that a
    rebuild gives the same layout.
    """
    u = users.to(torch.float32)
    n = u.shape[0]
    if -(-n // block_size) < 2:
        return None
    if init_rows is None:
        K = int(n_clusters) if n_clusters else int(
            np.clip(n // (4 * block_size), 2, 128))
        K = min(K, n)
        generator = torch.Generator(device=u.device)
        generator.manual_seed(0)
        init_rows = torch.randperm(n, generator=generator,
                                   device=u.device)[:K]
    centers = u[init_rows.to(device=u.device, dtype=torch.int64)]
    assign = torch.zeros(n, dtype=torch.int64, device=u.device)
    for _ in range(max(int(iters), 1)):
        assign, centers = _kmeans_step(u, centers)
    d2 = torch.sum((u - centers[assign]) ** 2, dim=1)
    # (cluster, distance, row id): stable sorts, the last key first
    by_dist = torch.sort(d2, stable=True).indices
    by_cluster = torch.sort(assign[by_dist], stable=True).indices
    return by_dist[by_cluster]


def _envelope_bounds(summary: BlockSummary, qs: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Certified per-(block, query) bounds (r_lo_opt, r_up_pes), each
    (nb, B): r_lo_opt ≤ min r↓ and r_up_pes ≥ max r↑ over the members.

    The score range is the box range, intersected with the norm-band ×
    angular-cone range when the summary has cones; the envelopes then
    bucketize it as `query.lookup_bounds_batch` bucketizes a score.
    """
    d = qs.shape[1]
    qp = torch.clamp(qs, min=0.0)                          # (B, d)
    qn = torch.clamp(qs, max=0.0)
    s_hi = summary.dim_max @ qp.T + summary.dim_min @ qn.T  # (nb, B)
    s_lo = summary.dim_min @ qp.T + summary.dim_max @ qn.T
    absmax = torch.maximum(summary.dim_min.abs(), summary.dim_max.abs())
    slack = (_SCORE_SLACK * d) * (absmax @ qs.abs().T) + _SCORE_SLACK_ABS
    s_hi = s_hi + slack
    s_lo = s_lo - slack
    if summary.norm_min is not None:
        # cone ∩ box: s = ‖u‖·‖q‖·cos∠(u, q), ∠(u, q) ∈ [max(0, θ − r),
        # min(π, θ + r)], trig-free through the cosine addition formulas,
        # every cosine and norm widened where it can only loosen a bound
        cs = _cos_slack(d)
        q_norm = torch.sqrt(torch.sum(qs * qs, dim=1))      # (B,)
        q_hat = qs / torch.clamp(q_norm, min=1e-30)[:, None]
        cos_t = summary.mu @ q_hat.T                        # (nb, B)
        cos_r = summary.cos_r                               # (nb, 1)
        sin_r = torch.sqrt(torch.clamp(1.0 - cos_r * cos_r, min=0.0))
        ct_hi = torch.clamp(cos_t + cs, -1.0, 1.0)          # θ rounded down
        ct_lo = torch.clamp(cos_t - cs, -1.0, 1.0)          # θ rounded up
        st_hi = torch.sqrt(torch.clamp(1.0 - ct_hi * ct_hi, min=0.0))
        st_lo = torch.sqrt(torch.clamp(1.0 - ct_lo * ct_lo, min=0.0))
        # θ ≤ r: the cone holds q̂'s direction (cos max 1); θ + r ≥ π: it
        # holds −q̂ (cos min −1)
        c_hi = torch.where(ct_hi >= cos_r, 1.0,
                           ct_hi * cos_r + st_hi * sin_r) + cs
        c_lo = torch.where(ct_lo <= -cos_r, -1.0,
                           ct_lo * cos_r - st_lo * sin_r) - cs
        n_lo, n_hi = summary.norm_min, summary.norm_max     # (nb, 1)
        q_lo = (q_norm * (1.0 - cs))[None, :]
        q_up = (q_norm * (1.0 + cs))[None, :]
        # member-dot rounding, Cauchy-Schwarz-bounded: Σ|u_j·q_j| ≤ n↑·‖q‖
        pad = (_SCORE_SLACK * d) * (n_hi * q_up) + _SCORE_SLACK_ABS
        s_hi_cone = torch.where(c_hi >= 0.0, n_hi * c_hi * q_up,
                                n_lo * c_hi * q_lo) + pad
        s_lo_cone = torch.where(c_lo >= 0.0, n_lo * c_lo * q_lo,
                                n_hi * c_lo * q_up) - pad
        s_hi = torch.minimum(s_hi, s_hi_cone)
        s_lo = torch.maximum(s_lo, s_lo_cone)
    if summary.user_slack is not None:
        # quantized user rows: each member's certified score interval is
        # ± row_slack·‖q‖₁ around the dequantized score, with the ‖q‖₁
        # that the member lookup uses
        extra = summary.user_slack * query_l1(qs)[None, :]
        s_hi = s_hi + extra
        s_lo = s_lo - extra

    tau = summary.tau
    m_plus_1 = float(summary.m + 1)
    if summary.score_eps is not None:
        # certified-widened envelopes (quantized table): the score side
        # adds the bf16 rounding of the member comparison
        e = summary.score_eps * torch.maximum(s_lo.abs(), s_hi.abs()) \
            + _SCORE_SLACK_ABS
        idx_hi = _bucketize(summary.thr_min, s_hi + e)      # ≥ member idx_hi
        # a member below its top threshold reads a widened table entry,
        # which can fall below 1.0: floor at the widened minimum
        r_lo_opt = torch.where(
            idx_hi == tau, torch.clamp(summary.tab_min[:, -1:], max=1.0),
            torch.gather(summary.tab_min, 1,
                         torch.clamp(idx_hi, 0, tau - 1)))
        idx_lo = _bucketize(summary.thr_max, s_lo - e)      # ≤ member idx_lo
        top = torch.clamp(summary.tab_max[:, :1], min=m_plus_1)
        r_up_pes = torch.where(
            idx_lo == 0, top,
            torch.gather(summary.tab_max, 1,
                         torch.clamp(idx_lo - 1, 0, tau - 1)))
        # the member path recomputes the widened values in another
        # order; one ppm keeps the envelopes a certified superset
        return r_lo_opt * (1.0 - 1e-6), r_up_pes * (1.0 + 1e-6)
    idx_hi = _bucketize(summary.thr_min, s_hi)              # ≥ member idx
    r_lo_opt = torch.where(
        idx_hi == tau, 1.0,
        torch.gather(summary.tab_min, 1, torch.clamp(idx_hi, 0, tau - 1)))
    idx_lo = _bucketize(summary.thr_max, s_lo)              # ≤ member idx
    top = torch.clamp(summary.tab_max[:, :1], min=m_plus_1)
    r_up_pes = torch.where(
        idx_lo == 0, top,
        torch.gather(summary.tab_max, 1,
                     torch.clamp(idx_lo - 1, 0, tau - 1)))
    return r_lo_opt, r_up_pes


def phase_a(summary: BlockSummary, qs: torch.Tensor, *, k: int,
            n_add: int = 0, n_del: int = 0,
            user_live: Optional[torch.Tensor] = None,
            block_size: int = DEFAULT_BLOCK
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Coarse pass: which blocks can hold answers, per query.

    Returns (keep, R̂): keep (B, nb) bool, True where the block might hold
    a user that Lemma 1 does not prune for that query; R̂ (B,) a certified
    upper bound on R↑_k. R̂ comes from sorting blocks by their r↑ bound
    and accumulating live rows to k: the k-th smallest r↑ over all users
    is at most the bound of the block where the count crosses k. Any
    order of tied bounds gives the same R̂, so the sort need not be
    stable.

    On a mutated index `n_add`/`n_del` (the correction's padded widths)
    widen r↑ and r↓, and `user_live` (n,) subtracts each block's deleted
    rows (blocks of `block_size`) from its live count.
    """
    r_lo_opt, r_up_pes = _envelope_bounds(summary, qs)      # (nb, B)
    r_lo_opt = r_lo_opt - float(n_del)
    r_up_pes = r_up_pes + float(n_add)
    live = summary.rows
    if user_live is not None:
        live = live - _per_block((~user_live).to(torch.int32), block_size,
                                 "sum").to(live.dtype)
    vals, order = torch.sort(r_up_pes, dim=0)
    cum = torch.cumsum(live[order], dim=0)                  # (nb, B)
    pos = torch.clamp((cum < k).sum(dim=0), max=summary.n_blocks - 1)
    r_hat = torch.where(cum[-1] >= k, vals.gather(0, pos[None, :])[0],
                        torch.inf)
    keep = (r_lo_opt <= r_hat[None, :]) & (live > 0)[:, None]
    return keep.T, r_hat


# --------------------------------------------------------------- phase B
def bucket_width(count: int, *, n_blocks: int, min_blocks: int = 1) -> int:
    """Round a kept-block count up to a width of granularity n_blocks/16
    (at least 8), so that the phase-B shapes repeat across batches and
    the padding stays near 6 % of the index."""
    g = max(8, n_blocks // 16)
    target = max(count, int(min_blocks), 1)
    return min(max(-(-target // g) * g, target), max(n_blocks, target))


def bucket_blocks(kept: np.ndarray, *, n_blocks: int, min_blocks: int = 1
                  ) -> np.ndarray:
    """Pad the kept-block id list to the bucketed width by repeating kept
    ids: duplicates recompute identical values, and the per-query keep
    mask (not the id list) decides what survives."""
    kept = np.asarray(kept, np.int32)
    if kept.size == 0:
        kept = np.zeros(1, np.int32)            # degenerate: nothing live
    width = bucket_width(kept.size, n_blocks=n_blocks,
                         min_blocks=min_blocks)
    reps = -(-width // kept.size)
    return np.tile(kept, reps)[:width]


def row_indices(block_ids: torch.Tensor, block_size: int) -> torch.Tensor:
    """(nk,) block ids → (nk·block_size,) row ids, which may pass n on
    the tail block (gathers clip them, the selection masks them)."""
    return (block_ids[:, None] * block_size
            + torch.arange(block_size, dtype=block_ids.dtype,
                           device=block_ids.device)[None, :]).reshape(-1)


def materialize(vals: torch.Tensor, block_ids: torch.Tensor,
                keep_q: torch.Tensor, n: int, sentinel: float,
                block_size: int) -> torch.Tensor:
    """Expand compacted (B, nk·bs) phase-B values into dense (B, n)
    arrays, masked by the per-query keep mask.

    A gather through the inverse block map (to the first copy of a
    duplicated id: every copy holds the same values); columns of unkept
    blocks read the sentinel. The per-query mask decides, so a query's
    arrays do not depend on its batch-mates."""
    B = vals.shape[0]
    nk = block_ids.shape[0]
    nb = keep_q.shape[1]
    dev = vals.device
    ids = block_ids.to(torch.int64)
    inv = torch.full((nb,), nk * block_size, dtype=torch.int64, device=dev)
    inv = inv.scatter_reduce(
        0, ids, torch.arange(nk, device=dev) * block_size, "amin")
    cols = torch.arange(n, device=dev)
    blk_of = cols // block_size
    src = torch.clamp(inv[blk_of] + cols % block_size, max=nk * block_size)
    padded = torch.cat(
        [vals, torch.full((B, 1), sentinel, dtype=torch.float32,
                          device=dev)], dim=1)
    out = padded[:, src]
    keep_rows = keep_q[:, blk_of]                           # (B, n)
    return torch.where(keep_rows, out, sentinel)


def finish_compacted(r_lo_c: torch.Tensor, r_up_c: torch.Tensor,
                     est_c: torch.Tensor, block_ids: torch.Tensor,
                     blk_valid: torch.Tensor, keep_q: torch.Tensor,
                     m_items: int, k: int, c: float, n: int,
                     block_size: int) -> QueryResult:
    """§4.3 steps 2-3 on the compacted (B, nk·bs) phase-B arrays.

    Rows not kept for their query (skipped, duplicate padding tiles, rows
    past n) read the dominated sentinel m + 2. The valid tiles are in
    ascending global order, so the stable-sort selection's ties go to
    the lower compacted position, which is the lower user index, as in
    the full scan. Only r↓/r↑ are materialized to (B, n); the accept and
    prune counts are recomputed from them.
    """
    ridx = row_indices(block_ids, block_size)               # (nk·bs,)
    sentinel = float(m_items + 2)
    live_blk = keep_q[:, block_ids.to(torch.int64)] & blk_valid[None, :]
    live = (torch.repeat_interleave(live_blk, block_size, dim=1)
            & (ridx < n)[None, :])                          # (B, nk·bs)
    r_lo_s = torch.where(live, r_lo_c, sentinel)
    r_up_s = torch.where(live, r_up_c, sentinel)
    est_s = torch.where(live, est_c, sentinel)
    R_lo_k = kth_smallest(r_lo_s, k)
    R_up_k = kth_smallest(r_up_s, k)
    sel, guaranteed, _, _ = lemma1_select(
        r_lo_s, r_up_s, est_s, R_lo_k=R_lo_k, R_up_k=R_up_k, k=k, c=c,
        m_items=m_items)
    indices = ridx.to(torch.int64)[sel]                     # global rows
    est_rank = torch.gather(est_s, -1, sel)
    r_lo_m = materialize(r_lo_c, block_ids, keep_q, n, sentinel,
                         block_size)
    r_up_m = materialize(r_up_c, block_ids, keep_q, n, sentinel,
                         block_size)
    accepted = r_up_m <= (c * R_lo_k)[..., None]
    pruned = r_lo_m > R_up_k[..., None]
    return QueryResult(
        indices=indices, est_rank=est_rank, r_lo=r_lo_m, r_up=r_up_m,
        R_lo_k=R_lo_k, R_up_k=R_up_k, guaranteed=guaranteed,
        n_accepted=accepted.sum(dim=-1, dtype=torch.int32),
        n_pruned=pruned.sum(dim=-1, dtype=torch.int32))


def _gathered_bounds(rt: RankTable, users, qs: torch.Tensor,
                     block_ids: torch.Tensor, block_size: int,
                     corr: Optional[DeltaCorrection] = None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compacted dense step 1: gather the kept rows (the int8 and slack
    vectors with them), one (nk·bs, d) × (d, B) product, one pass over
    the kept threshold/table rows, and on a mutated index the delta
    correction of those rows. Returns (B, nk·bs) arrays."""
    n = users.shape[0]
    g = torch.clamp(row_indices(block_ids, block_size), max=n - 1)
    scores, slack = user_scores_batch(take_user_rows(users, g), qs)
    r_lo, r_up, est = lookup_bounds_batch(rt.take_rows(g), scores, slack)
    if corr is not None:
        from repro_torch.core.rank_table import apply_delta_corrections
        r_lo, r_up, est = apply_delta_corrections(
            scores, r_lo, r_up, est, corr.take_rows(g), slack=slack)
    return r_lo.T, r_up.T, est.T


def pruned_query_batch(rt: RankTable, users, qs: torch.Tensor,
                       block_ids: torch.Tensor, blk_valid: torch.Tensor,
                       keep_q: torch.Tensor, k: int, c: float,
                       block_size: int = DEFAULT_BLOCK) -> QueryResult:
    """Dense phase B: compacted step 1, then the compacted selection."""
    r_lo, r_up, est = _gathered_bounds(rt, users, qs, block_ids,
                                       block_size)
    return finish_compacted(r_lo, r_up, est, block_ids, blk_valid, keep_q,
                            rt.m, k, c, users.shape[0], block_size)


def pruned_query_batch_delta(rt: RankTable, users, qs: torch.Tensor,
                             corr: DeltaCorrection, block_ids: torch.Tensor,
                             blk_valid: torch.Tensor, keep_q: torch.Tensor,
                             k: int, c: float,
                             block_size: int = DEFAULT_BLOCK) -> QueryResult:
    """Dense phase B over a mutated index: compacted step 1 with the
    correction, then the compacted selection at `corr.selection_m()`."""
    r_lo, r_up, est = _gathered_bounds(rt, users, qs, block_ids,
                                       block_size, corr=corr)
    return finish_compacted(r_lo, r_up, est, block_ids, blk_valid, keep_q,
                            corr.selection_m(), k, c, users.shape[0],
                            block_size)


def delta_finish_compacted(users, qs: torch.Tensor, corr: DeltaCorrection,
                           r_lo_c: torch.Tensor, r_up_c: torch.Tensor,
                           est_c: torch.Tensor, block_ids: torch.Tensor,
                           blk_valid: torch.Tensor, keep_q: torch.Tensor,
                           k: int, c: float, n: int, block_size: int
                           ) -> QueryResult:
    """The delta tail of compacted-bounds backends (K6/K7 on the fused
    path, generic inners): the correction needs u·q of the kept rows,
    one gathered product as the full scan's `_delta_query` takes one,
    then the correction and the compacted selection."""
    from repro_torch.core.rank_table import apply_delta_corrections
    g = torch.clamp(row_indices(block_ids, block_size), max=n - 1)
    scores, slack = user_scores_batch(take_user_rows(users, g), qs)
    r_lo, r_up, est = apply_delta_corrections(
        scores, r_lo_c.T, r_up_c.T, est_c.T, corr.take_rows(g), slack=slack)
    return finish_compacted(r_lo.T, r_up.T, est.T, block_ids, blk_valid,
                            keep_q, corr.selection_m(), k, c, n, block_size)
