"""K1, K4, K5, K6 and K7 launchers: fused U·Qᵀ + rank-table lookup (§4.3
step 1).

K1 replaces the TPU kernel `repro/kernels/user_scores.py`
(`bound_ranks_batched_kernel_call`, and its B = 1 twin
`bound_ranks_kernel_call`, which is this kernel called with B = 1); its
CUDA source is `csrc/user_scores.cu` and its public wrapper
`ops.bound_ranks_batched`. K4 and K5 replace the bf16 and int8 kernels of
`bound_ranks_batched_quant_kernel_call`; their source is
`csrc/user_scores_quant.cu` and their public wrapper
`ops.bound_ranks_batched_stored`.

The elastic entries of K1, K4 and K5 (`n_valid=`) read their row count
from device memory when they start, so that a CUDA graph of the elastic
program (`core.elastic`) replays one launch at every count; they take
the place of the TPU tile unit `repro/kernels/ops.py::bound_ranks_tile`
(`ops.bound_ranks_batched_stored(..., n_valid)`).

K6 and K7 replace the masked-grid kernels of block pruning
(`bound_ranks_batched_masked_kernel_call` and
`bound_ranks_batched_quant_masked_kernel_call`): the same kernels behind
a row map `block_ids`, one id per `block_n` rows, with compacted outputs
(`ops.bound_ranks_batched_pruned`, `ops.bound_ranks_batched_pruned_stored`).

Bound on the card: memory — U once, and per user and query the few
threshold and table sectors that a search touches (K5 reads no
thresholds). K1 at B > 1 and K4 at every B read each thresholds row
whole, once for all the queries of a launch, staged with the user rows
where it fits a stage; K1 at B = 1 reads a few 32-byte sectors of each
thresholds row (t[0], t[τ−1] and the sectors of the column the build's
even grid puts the score at; a bisection of the sectors only where that
misses) and none of the rest. K6/K7: the same over the kept rows.

All five kernels are one ring kernel (`csrc/step1_ring.cuh`): a producer
warp stages tiles of rows through a shared-memory ring by bulk
asynchronous copies, reading a row map's entry once a tile (K6/K7), and
eight consumer warps score them. An array may start at any 4-byte
address (a view at an offset); Qᵀ streams through shared memory in
256-row chunks where it does not fit whole, and rows too long for two
stages of whole rows (d past about 25,000 at f32) stream through the ring
in chunks, with the same scores. `launch_config` (K1/K6) and
`quant_launch_config` (K4/K5/K7) report a launch's tile, stages and the
kernel's registers, read on the card.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.query import int8_constants
from repro_torch.core.types import EPS_BF16
from repro_torch.kernels import _build

MAX_B = 16                       # queries per launch (kMaxB in the source)


def bound_ranks_batched_kernel_call(users: torch.Tensor, qs: torch.Tensor,
                                    thresholds: torch.Tensor,
                                    table: torch.Tensor, r_lo: torch.Tensor,
                                    r_up: torch.Tensor, est: torch.Tensor, *,
                                    m: int,
                                    block_ids: Optional[torch.Tensor] = None,
                                    block_n: int = 0,
                                    n_valid: Optional[torch.Tensor] = None
                                    ) -> None:
    """One K1 launch for ≤ 16 queries qs (nb, d), or with `block_ids`
    (nk,) int32 one K6 launch over the nk tiles of `block_n` rows they
    name, or with `n_valid` (a 1-element int32 device tensor) one launch
    of K1's elastic entry over the first *n_valid of the n rows, read on
    the device. Writes row-major (rows, nb) outputs, rows = n or
    nk·block_n, which may be column slices of wider arrays (row stride
    r_lo.stride(0)). Inputs are checked by the caller."""
    n, d = users.shape
    stream = torch.cuda.current_stream(users.device).cuda_stream
    common = (r_lo.data_ptr(), r_up.data_ptr(), est.data_ptr(), n, d,
              qs.shape[0], thresholds.shape[1], r_lo.stride(0),
              float(m + 1))
    if n_valid is not None:
        _build.call("user_scores", "k1_bound_ranks_elastic",
                    users.data_ptr(), qs.data_ptr(), thresholds.data_ptr(),
                    table.data_ptr(), n_valid.data_ptr(), *common, stream)
        return
    if block_ids is None:
        _build.call("user_scores", "k1_bound_ranks", users.data_ptr(),
                    qs.data_ptr(), thresholds.data_ptr(), table.data_ptr(),
                    *common, stream)
        return
    _build.call("user_scores", "k6_bound_ranks_masked", users.data_ptr(),
                qs.data_ptr(), thresholds.data_ptr(), table.data_ptr(),
                block_ids.data_ptr(), *common, block_ids.shape[0], block_n,
                stream)


def bound_ranks_quant_kernel_call(kind: str, rows: torch.Tensor,
                                  uscale, uslack: torch.Tensor,
                                  qs: torch.Tensor, qnorm1: torch.Tensor,
                                  rt, r_lo: torch.Tensor, r_up: torch.Tensor,
                                  est: torch.Tensor,
                                  block_ids: Optional[torch.Tensor] = None,
                                  block_n: int = 0,
                                  n_valid: Optional[torch.Tensor] = None
                                  ) -> None:
    """One K4 (kind "bf16") or K5 (kind "int8") launch for ≤ 16 queries
    qs (nb, d) with their ‖q‖₁ `qnorm1` (nb,), or with `block_ids` one
    K7 launch over the tiles they name, or with `n_valid` (a 1-element
    int32 device tensor) one launch of the elastic entry over the first
    *n_valid rows, read on the device. rows are the stored dtype or
    f32; uslack (n, 1) f32, and for K5 uscale (n, 1) f32. Writes
    row-major (rows, nb) outputs, which may be column slices of wider
    arrays. Inputs are checked by the caller."""
    n, d = rows.shape
    tau = rt.tau
    rows_f32 = int(rows.dtype == torch.float32)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    common = (r_lo.data_ptr(), r_up.data_ptr(), est.data_ptr(), n, d,
              qs.shape[0], tau, r_lo.stride(0), float(rt.m + 1))
    masked = block_ids is not None
    elastic = n_valid is not None
    ids = (block_ids.data_ptr(),) if masked else \
        (n_valid.data_ptr(),) if elastic else ()
    tail = (block_ids.shape[0], block_n, stream) if masked else (stream,)
    suffix = "_masked" if masked else "_elastic" if elastic else ""
    if kind == "bf16":
        symbol = ("k7_bound_ranks_bf16" if masked
                  else "k4_bound_ranks_bf16") + suffix
        _build.call("user_scores_quant", symbol, rows.data_ptr(), rows_f32,
                    uslack.data_ptr(), qs.data_ptr(), qnorm1.data_ptr(),
                    rt.thresholds.data_ptr(), rt.table.data_ptr(), *ids,
                    *common, 1.0 + EPS_BF16, 1.0 - EPS_BF16, *tail)
        return
    delta, dev_pad, widen_c = int8_constants(tau)
    symbol = ("k7_bound_ranks_int8" if masked
              else "k5_bound_ranks_int8") + suffix
    _build.call("user_scores_quant", symbol, rows.data_ptr(), rows_f32,
                uscale.data_ptr(), uslack.data_ptr(), qs.data_ptr(),
                qnorm1.data_ptr(), rt.thr_scale.data_ptr(),
                rt.thr_off.data_ptr(), rt.thr_dev.data_ptr(),
                rt.table.data_ptr(), rt.tab_scale.data_ptr(),
                rt.tab_off.data_ptr(), *ids, *common, delta, dev_pad,
                widen_c, *tail)


CONFIG_FIELDS = ("tile_rows", "stages", "thresholds_staged", "smem_bytes",
                 "blocks_per_sm", "registers", "local_bytes", "q_rows",
                 "static_smem_bytes", "row_chunk")


def launch_config(B: int, d: int, tau: int, masked: bool = False) -> dict:
    """The launch a K1 (or, masked, K6) call makes at these sizes and its
    kernel's resources, read on the card: the fields of
    `quant_launch_config`, `thresholds_staged` 1 where the thresholds rows
    ride the ring (more than one query, where they fit a stage)."""
    out = (ctypes.c_int * len(CONFIG_FIELDS))()
    _build.call("user_scores", "k1_launch_config", B, d, tau, int(masked),
                ctypes.addressof(out))
    return dict(zip(CONFIG_FIELDS, out))


def quant_launch_config(kind: str, rows_f32: bool, B: int, d: int,
                        tau: int, masked: bool = False) -> dict:
    """The launch a K4 (kind "bf16"), K5 ("int8") or, masked, K7 call
    makes at these sizes and its kernel's resources, read on the card
    (`cudaFuncGetAttributes`): rows a tile, ring stages, whether K4's
    thresholds rows are staged, dynamic shared memory, blocks an SM,
    registers and local (spill) bytes a thread, rows of Qᵀ held at once,
    static shared memory, and the values of each row a stage holds (d, or
    the chunk where rows stream through the ring)."""
    out = (ctypes.c_int * len(CONFIG_FIELDS))()
    _build.call("user_scores_quant", "quant_launch_config",
                0 if kind == "bf16" else 1, int(rows_f32), B, d, tau,
                int(masked), ctypes.addressof(out))
    return dict(zip(CONFIG_FIELDS, out))
