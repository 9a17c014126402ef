"""Public wrappers of the CUDA kernels K1-K3.

Each wrapper checks dtype, shape, device and contiguity, then: for CPU
tensors it runs the plain version in `ref.py`; for CUDA tensors it
launches its kernel on PyTorch's current stream, or raises. There is no
fallback from a CUDA tensor to the plain version.

`LAUNCHES` counts kernel launches per kernel, and nothing else, so a run
can show that its main path went through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import exact_rank, ref, table_build, user_scores

LAUNCHES = {"k1_bound_ranks": 0, "k2_table_build": 0, "k3_exact_ranks": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(name: str, t: torch.Tensor, ndim: int, device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def bound_ranks_batched(users: torch.Tensor, qs: torch.Tensor,
                        thresholds: torch.Tensor, table: torch.Tensor, *,
                        m: int
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1: fused scores + rank-table lookup for a (B, d) query block.

    users (n, d), qs (B, d), thresholds/table (n, τ), all f32. Returns
    (r_lo, r_up, est), each (B, n), query-major (views of user-major
    (n, B) results). On CUDA, one launch per 16 queries; each reads the
    thresholds row once for all its queries.
    """
    dev = users.device
    _check("users", users, 2, dev)
    _check("qs", qs, 2, dev)
    _check("thresholds", thresholds, 2, dev)
    _check("table", table, 2, dev)
    n, d = users.shape
    B = qs.shape[0]
    tau = thresholds.shape[1]
    if qs.shape[1] != d or thresholds.shape[0] != n \
            or table.shape != thresholds.shape or tau < 1:
        raise ValueError(f"shape mismatch: users {tuple(users.shape)}, qs "
                         f"{tuple(qs.shape)}, thresholds "
                         f"{tuple(thresholds.shape)}, table "
                         f"{tuple(table.shape)}")
    if dev.type == "cpu":
        r_lo, r_up, est = ref.ref_bound_ranks(users, qs, thresholds, table, m)
        return r_lo.T, r_up.T, est.T
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    user_scores.check_shape(d)
    out = torch.empty((3, n, B), dtype=torch.float32, device=dev)
    for b0 in range(0, B, user_scores.MAX_B):
        b1 = min(B, b0 + user_scores.MAX_B)
        user_scores.bound_ranks_batched_kernel_call(
            users, qs[b0:b1], thresholds, table, out[0, :, b0:b1],
            out[1, :, b0:b1], out[2, :, b0:b1], m=m)
        LAUNCHES["k1_bound_ranks"] += 1
    return out[0].T, out[1].T, out[2].T


def bound_ranks(users: torch.Tensor, q: torch.Tensor,
                thresholds: torch.Tensor, table: torch.Tensor, *, m: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 for one query q (d,) → (r_lo, r_up, est), each (n,)."""
    r_lo, r_up, est = bound_ranks_batched(users, q[None, :], thresholds,
                                          table, m=m)
    return r_lo[0], r_up[0], est[0]


def build_table_rows(users: torch.Tensor, samples: torch.Tensor,
                     weights: torch.Tensor, thresholds: torch.Tensor
                     ) -> torch.Tensor:
    """K2: Eq. (1) rows 1 + Σ_s w_s·I[u·p_s > t_j] for all users.

    users (n, d), samples (S, d), weights (S,), thresholds (n, τ), all
    f32 → (n, τ) f32.
    """
    dev = users.device
    _check("users", users, 2, dev)
    _check("samples", samples, 2, dev)
    _check("weights", weights, 1, dev)
    _check("thresholds", thresholds, 2, dev)
    n, d = users.shape
    S = samples.shape[0]
    if samples.shape[1] != d or weights.shape[0] != S \
            or thresholds.shape[0] != n:
        raise ValueError(f"shape mismatch: users {tuple(users.shape)}, "
                         f"samples {tuple(samples.shape)}, weights "
                         f"{tuple(weights.shape)}, thresholds "
                         f"{tuple(thresholds.shape)}")
    if dev.type == "cpu":
        return ref.estimate_table_rows(users @ samples.T, weights,
                                       thresholds)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    table_build.check_shape(d, S)
    out = table_build.table_build_kernel_call(users, samples, weights,
                                              thresholds)
    LAUNCHES["k2_table_build"] += 1
    return out


def exact_ranks(users: torch.Tensor, items: torch.Tensor, q: torch.Tensor,
                *, block: int = 4096) -> torch.Tensor:
    """K3: Definition-1 ranks 1 + #{p : u·p > u·q} → (n,) int32.

    users (n, d), items (m, d), q (d,), all f32. The kernel computes u·q
    by the same loop as every u·p, so for q ∈ P the item equal to q
    never counts against itself. `block` is the user-block size of the
    plain version on the CPU.
    """
    dev = users.device
    _check("users", users, 2, dev)
    _check("items", items, 2, dev)
    _check("q", q, 1, dev)
    n, d = users.shape
    if items.shape[1] != d or q.shape[0] != d:
        raise ValueError(f"shape mismatch: users {tuple(users.shape)}, "
                         f"items {tuple(items.shape)}, q {tuple(q.shape)}")
    if dev.type == "cpu":
        return 1 + ref.ref_exact_counts(users, items, q, block=block)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    exact_rank.check_shape(d)
    out = exact_rank.exact_ranks_kernel_call(users, items, q)
    LAUNCHES["k3_exact_ranks"] += 1
    return out
