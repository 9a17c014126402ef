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
