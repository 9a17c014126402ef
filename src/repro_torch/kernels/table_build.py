"""K2 launcher: Eq. (1) rows of Algorithm 1.

Replaces the TPU kernel `repro/kernels/table_build.py`
(`table_build_kernel_call`). The CUDA source is `csrc/table_build.cu`;
the public wrapper with its checks and launch count is
`ops.build_table_rows`.

Bound on the card: operations, the 2·n·S·d f32 FLOP of the product
U·Samplesᵀ. A call packs the samples once into K3's ring layout, then
per chunk of users runs the product (K3's tiling) into a workspace of
scores that stays in L2, and the count: one warp a user sorts its scores
in registers (each with its weight, unless the weights of a part of the
samples are all equal), and places each threshold by binary search, so
a row of thresholds may hold any order. Any n, d, S, τ ≥ 1 and arrays at
any 4-byte address. The table is bitwise the parent kernel's wherever
every partial sum of the weights is exact in f32 (equal dyadic or small
integer weights); `csrc/table_build.cu`'s header has the contract.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

CONFIG_FIELDS = ("block_users", "tile_samples", "stage_depth", "stages",
                 "users_resident", "smem_bytes", "blocks_per_sm",
                 "registers", "local_bytes", "count_users_per_block",
                 "count_run", "count_smem_bytes", "count_blocks_per_sm",
                 "count_registers", "count_local_bytes", "chunk_users",
                 "workspace_bytes")


def table_build_kernel_call(users: torch.Tensor, samples: torch.Tensor,
                            weights: torch.Tensor, thresholds: torch.Tensor
                            ) -> torch.Tensor:
    """One K2 call (the pack, then a product and a count launch a chunk
    of users) → (n, τ) f32 table. Inputs are checked by the caller."""
    n, d = users.shape
    S = samples.shape[0]
    plan = (ctypes.c_longlong * 2)()
    _build.call("table_build", "k2_plan", n, d, S, ctypes.addressof(plan))
    work = torch.empty(plan[1], dtype=torch.float32, device=users.device)
    out = torch.empty_like(thresholds)
    _build.call("table_build", "k2_table_build", users.data_ptr(),
                samples.data_ptr(), weights.data_ptr(), thresholds.data_ptr(),
                out.data_ptr(), work.data_ptr(), n, d, S,
                thresholds.shape[1], plan[0],
                torch.cuda.current_stream(users.device).cuda_stream)
    return out


def launch_config(n: int, d: int, S: int) -> dict:
    """The launches a K2 call at (n, d, S) makes and their kernels'
    resources, read on the card (`cudaFuncGetAttributes`): the product's
    users a block, samples a tile, depths a ring stage, stages, whether
    the user tile stays resident, dynamic shared memory, blocks an SM,
    registers and local (spill) bytes a thread; the count's users a
    block, samples a run, shared memory, blocks an SM, registers and
    local bytes; users a chunk and the workspace's bytes."""
    out = (ctypes.c_longlong * len(CONFIG_FIELDS))()
    _build.call("table_build", "k2_launch_config", n, d, S,
                ctypes.addressof(out))
    return dict(zip(CONFIG_FIELDS, out))
