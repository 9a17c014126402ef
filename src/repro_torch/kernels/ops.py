"""Public wrappers of the CUDA kernels K1-K7.

Each wrapper checks dtype, shape, device and contiguity, then: for CPU
tensors it runs the plain version in `ref.py`; for CUDA tensors it
launches its kernel on PyTorch's current stream, or raises. There is no
fallback from a CUDA tensor to the plain version.

`LAUNCHES` counts kernel launches per kernel, and nothing else, so a run
can show that its main path went through the kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.query import query_l1
from repro_torch.core.types import RankTable, StoredUsers
from repro_torch.kernels import exact_rank, ref, table_build, user_scores

LAUNCHES = {"k1_bound_ranks": 0, "k2_table_build": 0, "k3_exact_ranks": 0,
            "k4_bound_ranks_bf16": 0, "k5_bound_ranks_int8": 0,
            "k6_bound_ranks_masked": 0, "k7_bound_ranks_bf16_masked": 0,
            "k7_bound_ranks_int8_masked": 0}
_QUANT_KERNEL = {"bf16": "k4_bound_ranks_bf16", "int8": "k5_bound_ranks_int8"}
_QUANT_MASKED = {"bf16": "k7_bound_ranks_bf16_masked",
                 "int8": "k7_bound_ranks_int8_masked"}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(name: str, t: torch.Tensor, ndim: int, device,
           dtypes=(torch.float32,)) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, "
                        f"got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_block_ids(block_ids: torch.Tensor, block_n: int, n: int,
                     device) -> None:
    """(nk,) int32 ids of tiles of `block_n` rows, each < ⌈n / block_n⌉
    (one host sync on CUDA: an id out of range would read past U)."""
    _check("block_ids", block_ids, 1, device, (torch.int32,))
    if block_n < 1 or block_ids.shape[0] < 1:
        raise ValueError(f"need block_n >= 1 and at least one block id, got "
                         f"block_n={block_n}, {block_ids.shape[0]} ids")
    lo, hi = (int(x) for x in torch.aminmax(block_ids))
    n_blocks = -(-n // block_n)
    if lo < 0 or hi >= n_blocks:
        raise ValueError(f"block ids must lie in [0, {n_blocks}), got "
                         f"[{lo}, {hi}]")


def _per_launch(name: str, rows: int, B: int, device, launch
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run `launch(b0, b1, r_lo, r_up, est)` on ≤ 16 queries at a time
    into row-major (rows, B) outputs, counting each launch under `name`.
    Returns (r_lo, r_up, est), each (B, rows), query-major."""
    out = torch.empty((3, rows, B), dtype=torch.float32, device=device)
    for b0 in range(0, B, user_scores.MAX_B):
        b1 = min(B, b0 + user_scores.MAX_B)
        launch(b0, b1, out[0, :, b0:b1], out[1, :, b0:b1], out[2, :, b0:b1])
        LAUNCHES[name] += 1
    return out[0].T, out[1].T, out[2].T


def _check_f32_step1(users, qs, thresholds, table) -> None:
    dev = users.device
    _check("users", users, 2, dev)
    _check("qs", qs, 2, dev)
    _check("thresholds", thresholds, 2, dev)
    _check("table", table, 2, dev)
    if qs.shape[1] != users.shape[1] \
            or thresholds.shape[0] != users.shape[0] \
            or table.shape != thresholds.shape or thresholds.shape[1] < 1:
        raise ValueError(f"shape mismatch: users {tuple(users.shape)}, qs "
                         f"{tuple(qs.shape)}, thresholds "
                         f"{tuple(thresholds.shape)}, table "
                         f"{tuple(table.shape)}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


def bound_ranks_batched(users: torch.Tensor, qs: torch.Tensor,
                        thresholds: torch.Tensor, table: torch.Tensor, *,
                        m: int
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1: fused scores + rank-table lookup for a (B, d) query block.

    users (n, d), qs (B, d), thresholds/table (n, τ), all f32. Returns
    (r_lo, r_up, est), each (B, n), query-major (views of user-major
    (n, B) results). On CUDA, one launch per 16 queries; each reads the
    thresholds row once for all its queries (one query reads only the few
    sectors of it that its search needs).
    """
    _check_f32_step1(users, qs, thresholds, table)
    if users.device.type == "cpu":
        r_lo, r_up, est = ref.ref_bound_ranks(users, qs, thresholds, table, m)
        return r_lo.T, r_up.T, est.T
    return _per_launch(
        "k1_bound_ranks", users.shape[0], qs.shape[0], users.device,
        lambda b0, b1, *o: user_scores.bound_ranks_batched_kernel_call(
            users, qs[b0:b1], thresholds, table, *o, m=m))


def bound_ranks_batched_pruned(users: torch.Tensor, qs: torch.Tensor,
                               thresholds: torch.Tensor, table: torch.Tensor,
                               block_ids: torch.Tensor, *, m: int,
                               block_n: int
                               ) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """K6: K1 over the user tiles named by `block_ids` only.

    block_ids (nk,) int32 names tiles of `block_n` rows. Returns COMPACTED
    (r_lo, r_up, est), each (B, nk·block_n), in block-list order: columns
    j·block_n .. of the outputs are the rows of tile block_ids[j], bitwise
    K1's values for them. Rows past n read m + 2. On CUDA, one launch
    per 16 queries.
    """
    _check_f32_step1(users, qs, thresholds, table)
    _check_block_ids(block_ids, block_n, users.shape[0], users.device)
    if users.device.type == "cpu":
        r_lo, r_up, est = ref.ref_bound_ranks_masked(
            users, qs, thresholds, table, m, block_ids, block_n)
        return r_lo.T, r_up.T, est.T
    return _per_launch(
        "k6_bound_ranks_masked", block_ids.shape[0] * block_n, qs.shape[0],
        users.device,
        lambda b0, b1, *o: user_scores.bound_ranks_batched_kernel_call(
            users, qs[b0:b1], thresholds, table, *o, m=m,
            block_ids=block_ids, block_n=block_n))


def bound_ranks(users: torch.Tensor, q: torch.Tensor,
                thresholds: torch.Tensor, table: torch.Tensor, *, m: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 for one query q (d,) → (r_lo, r_up, est), each (n,)."""
    r_lo, r_up, est = bound_ranks_batched(users, q[None, :], thresholds,
                                          table, m=m)
    return r_lo[0], r_up[0], est[0]


def stored_parts(users, kind: str
                 ) -> tuple[torch.Tensor, Optional[torch.Tensor],
                            torch.Tensor]:
    """(rows, uscale, uslack) of either user representation for a table
    of storage `kind`, the operands of K4 (no scale) or K5. Raw f32
    users get zero slack, and unit scale against an int8 table, with
    which the quantized lookup computes on the exact scores."""
    rows, uscale, uslack = (users if isinstance(users, StoredUsers)
                            else (users, None, None))
    vec = lambda v: torch.full((rows.shape[0], 1), v, dtype=torch.float32,
                               device=rows.device)
    if kind == "int8" and uscale is None:
        uscale = vec(1.0)
    if uslack is None:
        uslack = vec(0.0)
    return rows, uscale, uslack


def _quant_operands(users, qs: torch.Tensor, rt: RankTable):
    """The checked operands of K4/K5/K7 → (rows, uscale, uslack, ‖q‖₁).
    ‖q‖₁ is computed here once, so that a kernel and its plain version
    see the same slack."""
    kind = rt.spec_kind
    rows, uscale, uslack = stored_parts(users, kind)
    dev = rows.device
    stored = torch.bfloat16 if kind == "bf16" else torch.int8
    _check("rows", rows, 2, dev, (stored, torch.float32))
    _check("qs", qs, 2, dev)
    _check("table", rt.table, 2, dev, (stored,))
    vectors = {"uslack": uslack}
    if kind == "bf16":
        _check("thresholds", rt.thresholds, 2, dev, (stored,))
    else:
        vectors.update(uscale=uscale, thr_scale=rt.thr_scale,
                       thr_off=rt.thr_off,
                       thr_dev=rt.thr_dev, tab_scale=rt.tab_scale,
                       tab_off=rt.tab_off)
    n, d = rows.shape
    tau = rt.tau
    for name, v in vectors.items():
        _check(name, v, 2, dev)
        if v.shape != (n, 1):
            raise ValueError(f"{name} must be ({n}, 1), got "
                             f"{tuple(v.shape)}")
    if qs.shape[1] != d or rt.table.shape != (n, tau) \
            or rt.thresholds.shape != (n, tau) or tau < 2:
        raise ValueError(f"shape mismatch: rows {tuple(rows.shape)}, qs "
                         f"{tuple(qs.shape)}, thresholds "
                         f"{tuple(rt.thresholds.shape)}, table "
                         f"{tuple(rt.table.shape)}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return rows, uscale, uslack, query_l1(qs)


def bound_ranks_batched_stored(users, qs: torch.Tensor, rt: RankTable
                               ) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """The fused backend's step 1, dispatched on the table's storage.

    An f32 table with raw users goes to K1 (`bound_ranks_batched`); an
    f32 table with `StoredUsers` raises. A bf16 table goes to K4 and an
    int8 table to K5, with `users` stored (`StoredUsers`) or raw f32
    (unit scale, zero slack). ‖q‖₁ is computed once and shared by every
    launch and the plain version. Returns (r_lo, r_up, est), each (B, n),
    query-major. On CUDA, one launch per 16 queries.
    """
    kind = rt.spec_kind
    if kind == "f32":
        if isinstance(users, StoredUsers):
            raise ValueError("quantized user storage requires a quantized "
                             "rank table (uniform StorageSpec)")
        return bound_ranks_batched(users, qs, rt.thresholds, rt.table,
                                   m=rt.m)
    rows, uscale, uslack, qnorm1 = _quant_operands(users, qs, rt)
    if rows.device.type == "cpu":
        r_lo, r_up, est = ref.ref_bound_ranks_stored(rows, uscale, uslack,
                                                     qs, qnorm1, rt)
        return r_lo.T, r_up.T, est.T
    return _per_launch(
        _QUANT_KERNEL[kind], rows.shape[0], qs.shape[0], rows.device,
        lambda b0, b1, *o: user_scores.bound_ranks_quant_kernel_call(
            kind, rows, uscale, uslack, qs[b0:b1], qnorm1[b0:b1], rt, *o))


def bound_ranks_batched_pruned_stored(users, qs: torch.Tensor,
                                      rt: RankTable,
                                      block_ids: torch.Tensor, *,
                                      block_n: int
                                      ) -> tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]:
    """The pruned fused backend's step 1: `bound_ranks_batched_stored`
    over the user tiles named by `block_ids` only.

    An f32 table goes to K6 (`bound_ranks_batched_pruned`); a bf16 or
    int8 table to K7, whose per-row vectors ride the same tile map.
    Returns COMPACTED (r_lo, r_up, est), each (B, nk·block_n), in
    block-list order, bitwise the full scan's values on the kept rows;
    rows past n read m + 2. One ‖q‖₁ serves every launch.
    """
    kind = rt.spec_kind
    if kind == "f32":
        if isinstance(users, StoredUsers):
            raise ValueError("quantized user storage requires a quantized "
                             "rank table (uniform StorageSpec)")
        return bound_ranks_batched_pruned(users, qs, rt.thresholds,
                                          rt.table, block_ids, m=rt.m,
                                          block_n=block_n)
    rows, uscale, uslack, qnorm1 = _quant_operands(users, qs, rt)
    _check_block_ids(block_ids, block_n, rows.shape[0], rows.device)
    if rows.device.type == "cpu":
        r_lo, r_up, est = ref.ref_bound_ranks_stored_masked(
            rows, uscale, uslack, qs, qnorm1, rt, block_ids, block_n)
        return r_lo.T, r_up.T, est.T
    return _per_launch(
        _QUANT_MASKED[kind], block_ids.shape[0] * block_n, qs.shape[0],
        rows.device,
        lambda b0, b1, *o: user_scores.bound_ranks_quant_kernel_call(
            kind, rows, uscale, uslack, qs[b0:b1], qnorm1[b0:b1], rt, *o,
            block_ids=block_ids, block_n=block_n))


def build_table_rows(users: torch.Tensor, samples: torch.Tensor,
                     weights: torch.Tensor, thresholds: torch.Tensor
                     ) -> torch.Tensor:
    """K2: Eq. (1) rows 1 + Σ_s w_s·I[u·p_s > t_j] for all users.

    users (n, d), samples (S, d), weights (S,), thresholds (n, τ), all
    f32 → (n, τ) f32; a row of thresholds may hold any order. On CUDA,
    one call (its pack, product and count launches) counts one launch.
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
    out = exact_rank.exact_ranks_kernel_call(users, items, q)
    LAUNCHES["k3_exact_ranks"] += 1
    return out
