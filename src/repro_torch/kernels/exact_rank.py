"""K3 launcher: exact ranks by Definition 1 (the oracle).

Replaces the TPU kernel `repro/kernels/exact_rank.py`
(`exact_counts_kernel_call`), one query a launch. The CUDA source is
`csrc/exact_rank.cu`; the public wrapper with its checks and launch
count is `ops.exact_ranks`.

Bound on the card: operations, 2·n·m·d f32 FLOP per query. The kernel
takes any n, m, d >= 1 and arrays at any 4-byte address. A call first
packs P into a workspace, stage by stage of the kernel's ring, which it
then fills by one bulk copy a stage.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

CONFIG_FIELDS = ("block_users", "tile_items", "stage_depth", "stages",
                 "users_resident", "smem_bytes", "blocks_per_sm",
                 "registers", "local_bytes", "product_depth")


def exact_ranks_kernel_call(users: torch.Tensor, items: torch.Tensor,
                            q: torch.Tensor) -> torch.Tensor:
    """One K3 call (the pack, then the ranks) → (n,) int32 ranks
    1 + #{p : u·p > u·q}. Inputs are checked by the caller."""
    n, d = users.shape
    m = items.shape[0]
    size = ctypes.c_longlong()
    _build.call("exact_rank", "k3_workspace_floats", m, d,
                ctypes.byref(size))
    work = torch.empty(size.value, dtype=torch.float32, device=users.device)
    out = torch.empty(n, dtype=torch.int32, device=users.device)
    _build.call("exact_rank", "k3_exact_ranks", users.data_ptr(),
                items.data_ptr(), q.data_ptr(), out.data_ptr(),
                work.data_ptr(), n, m, d,
                torch.cuda.current_stream(users.device).cuda_stream)
    return out


def launch_config(d: int) -> dict:
    """The launch a K3 call at depth d makes and its kernel's resources,
    read on the card (`cudaFuncGetAttributes`): users a block, items a
    tile, depths a ring stage, stages, whether the user tile stays
    resident in shared memory, dynamic shared memory, blocks an SM,
    registers and local (spill) bytes a thread, and the depth the
    products run to (d rounded up to 4)."""
    out = (ctypes.c_int * len(CONFIG_FIELDS))()
    _build.call("exact_rank", "k3_launch_config", d, ctypes.addressof(out))
    return dict(zip(CONFIG_FIELDS, out))
