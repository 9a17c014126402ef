"""K1 launcher: fused U·Qᵀ + rank-table lookup (§4.3 step 1).

Replaces the TPU kernel `repro/kernels/user_scores.py`
(`bound_ranks_batched_kernel_call`, and its B = 1 twin
`bound_ranks_kernel_call`, which is this kernel called with B = 1). The
CUDA source is `csrc/user_scores.cu`; the public wrapper with its checks
and launch count is `ops.bound_ranks_batched`.

Bound on the card: memory — U once, and per user and query the few
threshold and table sectors that a search touches. This kernel reads
each thresholds row whole, once for all the queries of a launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_B = 16                       # queries per launch (kMaxB in the source)
_Q_STRIDE = MAX_B + 4            # floats per row of Qᵀ in shared memory
_T_TILES = 8 * 512               # a 512-float thresholds tile per warp
_SMEM = 48 * 1024                # both live in default shared memory


def check_shape(d: int) -> None:
    if (d * _Q_STRIDE + _T_TILES) * 4 > _SMEM:
        raise ValueError(f"K1 keeps Qᵀ in shared memory: d={d} exceeds "
                         f"{(_SMEM // 4 - _T_TILES) // _Q_STRIDE}")


def bound_ranks_batched_kernel_call(users: torch.Tensor, qs: torch.Tensor,
                                    thresholds: torch.Tensor,
                                    table: torch.Tensor, r_lo: torch.Tensor,
                                    r_up: torch.Tensor, est: torch.Tensor, *,
                                    m: int) -> None:
    """One K1 launch for ≤ 16 queries qs (nb, d). Writes user-major
    (n, nb) outputs, which may be column slices of wider arrays (row
    stride r_lo.stride(0)). Inputs are checked by the caller."""
    n, d = users.shape
    _build.call("user_scores", "k1_bound_ranks", users.data_ptr(),
                qs.data_ptr(), thresholds.data_ptr(), table.data_ptr(),
                r_lo.data_ptr(), r_up.data_ptr(), est.data_ptr(), n, d,
                qs.shape[0], thresholds.shape[1], r_lo.stride(0),
                float(m + 1), torch.cuda.current_stream(users.device)
                .cuda_stream)
