"""K1, K4 and K5 launchers: fused U·Qᵀ + rank-table lookup (§4.3 step 1).

K1 replaces the TPU kernel `repro/kernels/user_scores.py`
(`bound_ranks_batched_kernel_call`, and its B = 1 twin
`bound_ranks_kernel_call`, which is this kernel called with B = 1); its
CUDA source is `csrc/user_scores.cu` and its public wrapper
`ops.bound_ranks_batched`. K4 and K5 replace the bf16 and int8 kernels of
`bound_ranks_batched_quant_kernel_call`; their source is
`csrc/user_scores_quant.cu` and their public wrapper
`ops.bound_ranks_batched_stored`.

Bound on the card: memory — U once, and per user and query the few
threshold and table sectors that a search touches (K5 reads no
thresholds). K1 and K4 at B > 1 read each thresholds row whole, once
for all the queries of a launch.
"""
from __future__ import annotations

import torch

from repro_torch.core.query import int8_constants
from repro_torch.core.types import EPS_BF16
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


def bound_ranks_quant_kernel_call(kind: str, rows: torch.Tensor,
                                  uscale, uslack: torch.Tensor,
                                  qs: torch.Tensor, qnorm1: torch.Tensor,
                                  rt, r_lo: torch.Tensor, r_up: torch.Tensor,
                                  est: torch.Tensor) -> None:
    """One K4 (kind "bf16") or K5 (kind "int8") launch for ≤ 16 queries
    qs (nb, d) with their ‖q‖₁ `qnorm1` (nb,). rows are the stored dtype
    or f32; uslack (n, 1) f32, and for K5 uscale (n, 1) f32. Writes
    user-major (n, nb) outputs, which may be column slices of wider
    arrays. Inputs are checked by the caller."""
    n, d = rows.shape
    tau = rt.tau
    rows_f32 = int(rows.dtype == torch.float32)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    common = (r_lo.data_ptr(), r_up.data_ptr(), est.data_ptr(), n, d,
              qs.shape[0], tau, r_lo.stride(0), float(rt.m + 1))
    if kind == "bf16":
        _build.call("user_scores_quant", "k4_bound_ranks_bf16",
                    rows.data_ptr(), rows_f32, uslack.data_ptr(),
                    qs.data_ptr(), qnorm1.data_ptr(),
                    rt.thresholds.data_ptr(), rt.table.data_ptr(), *common,
                    1.0 + EPS_BF16, 1.0 - EPS_BF16, stream)
        return
    delta, dev_pad, widen_c = int8_constants(tau)
    _build.call("user_scores_quant", "k5_bound_ranks_int8", rows.data_ptr(),
                rows_f32, uscale.data_ptr(), uslack.data_ptr(),
                qs.data_ptr(), qnorm1.data_ptr(), rt.thr_scale.data_ptr(),
                rt.thr_off.data_ptr(), rt.thr_dev.data_ptr(),
                rt.table.data_ptr(), rt.tab_scale.data_ptr(),
                rt.tab_off.data_ptr(), *common, delta, dev_pad, widen_c,
                stream)
