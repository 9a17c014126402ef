"""K2 launcher: Eq. (1) rows of Algorithm 1.

Replaces the TPU kernel `repro/kernels/table_build.py`
(`table_build_kernel_call`). The CUDA source is `csrc/table_build.cu`;
the public wrapper with its checks and launch count is
`ops.build_table_rows`.

Bound on the card: the IEEE-f32 product U·Samplesᵀ, 2·n·S·d FLOP.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_SMEM_OPTIN = 227 * 1024


def smem_bytes(d: int, S: int) -> int:
    """Dynamic shared memory of one block: 8 user rows and 32 sample rows
    at an odd row stride, 8 users' S scores, the S weights."""
    stride = d + 1 if d % 2 == 0 else d
    return 4 * ((8 + 32) * stride + 8 * S + S)


def check_shape(d: int, S: int) -> None:
    if smem_bytes(d, S) > _SMEM_OPTIN:
        raise ValueError(f"K2 keeps each user's S={S} scores and a d={d} "
                         "sample chunk in shared memory: too large")


def table_build_kernel_call(users: torch.Tensor, samples: torch.Tensor,
                            weights: torch.Tensor, thresholds: torch.Tensor
                            ) -> torch.Tensor:
    """One K2 launch → (n, τ) f32 table. Inputs are checked by the
    caller."""
    n, d = users.shape
    out = torch.empty_like(thresholds)
    _build.call("table_build", "k2_table_build", users.data_ptr(),
                samples.data_ptr(), weights.data_ptr(), thresholds.data_ptr(),
                out.data_ptr(), n, d, samples.shape[0], thresholds.shape[1],
                torch.cuda.current_stream(users.device).cuda_stream)
    return out
