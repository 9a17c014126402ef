"""K3 launcher: exact ranks by Definition 1 (the oracle).

Replaces the TPU kernel `repro/kernels/exact_rank.py`
(`exact_counts_kernel_call`). The CUDA source is `csrc/exact_rank.cu`;
the public wrapper with its checks and launch count is
`ops.exact_ranks`.

Bound on the card: operations, 2·n·m·d f32 FLOP per query.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

def exact_ranks_kernel_call(users: torch.Tensor, items: torch.Tensor,
                            q: torch.Tensor) -> torch.Tensor:
    """One K3 launch → (n,) int32 ranks 1 + #{p : u·p > u·q}. Inputs
    are checked by the caller."""
    n, d = users.shape
    out = torch.empty(n, dtype=torch.int32, device=users.device)
    _build.call("exact_rank", "k3_exact_ranks", users.data_ptr(),
                items.data_ptr(), q.data_ptr(), out.data_ptr(), n,
                items.shape[0], d,
                torch.cuda.current_stream(users.device).cuda_stream)
    return out
