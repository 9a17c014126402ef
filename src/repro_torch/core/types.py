"""Core data types of the port (f32 storage only).

Counterpart of `repro/core/types.py`: the same configuration fields and
validation, the same `RankTable` / `QueryResult` fields. Quantized
storage (bf16, int8) is not ported yet (ROADMAP queue 1 item 6), so any
`storage_dtype` other than f32 raises `NotImplementedError`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

_F32_NAMES = ("float32", "f32")
_QUANT_NAMES = ("bf16", "bfloat16", "int8")


@dataclasses.dataclass(frozen=True)
class RankTableConfig:
    """Static configuration for Algorithm 1 (pre-processing).

    tau: thresholds per user (table columns); omega: norm-stratified
    partitions of P; s: samples per partition; threshold_mode: how
    f_min/f_max is obtained ("sampled", "norm_bound" or "exact");
    range_pad: fractional widening of the sampled range;
    sample_with_replacement: stratified sampling mode; storage_dtype:
    the storage spec, f32 only in the port so far.
    """

    tau: int = 500
    omega: int = 10
    s: int = 64
    threshold_mode: str = "sampled"
    range_pad: float = 0.05
    sample_with_replacement: bool = False
    storage_dtype: str = "float32"

    def __post_init__(self):
        if self.tau < 2:
            raise ValueError(f"tau must be >= 2, got {self.tau}")
        if self.omega < 1:
            raise ValueError(f"omega must be >= 1, got {self.omega}")
        if self.s < 1:
            raise ValueError(f"s must be >= 1, got {self.s}")
        if self.threshold_mode not in ("sampled", "norm_bound", "exact"):
            raise ValueError(f"unknown threshold_mode {self.threshold_mode!r}")
        spec = str(self.storage_dtype)
        if spec in _QUANT_NAMES:
            raise NotImplementedError(
                f"storage_dtype={spec!r}: quantized storage is not ported "
                "yet (ROADMAP queue 1 item 6); use 'float32'")
        if spec not in _F32_NAMES:
            raise ValueError(f"unknown storage spec {spec!r}; expected one "
                             f"of {sorted(_F32_NAMES + _QUANT_NAMES)}")


class RankTable(NamedTuple):
    """The paper's rank table T (§4.1) plus its per-user thresholds.

    thresholds: (n, tau) f32, ascending along axis 1.
    table:      (n, tau) f32, non-increasing along axis 1 (Eq. 1).
    m:          |P| as a Python int (the out-of-range upper bound is m+1).
    """

    thresholds: torch.Tensor
    table: torch.Tensor
    m: int

    @property
    def n(self) -> int:
        return self.thresholds.shape[0]

    @property
    def tau(self) -> int:
        return self.thresholds.shape[1]


class QueryResult(NamedTuple):
    """Output of one c-approximate reverse k-ranks query (§4.3); with a
    leading B axis on every field for a batch.

    indices (k,) int64 best-first; est_rank (k,) f32; r_lo/r_up (n,) f32;
    R_lo_k/R_up_k () f32; guaranteed () bool (c·R↓_k ≥ R↑_k);
    n_accepted/n_pruned () int32 (Lemma 1 (1) and (2)).
    """

    indices: torch.Tensor
    est_rank: torch.Tensor
    r_lo: torch.Tensor
    r_up: torch.Tensor
    R_lo_k: torch.Tensor
    R_up_k: torch.Tensor
    guaranteed: torch.Tensor
    n_accepted: torch.Tensor
    n_pruned: torch.Tensor


def kth_smallest(x: torch.Tensor, k: int) -> torch.Tensor:
    """k-th smallest value along the last axis (k is 1-indexed).

    Values only, so the tie order of `topk` does not matter. Not
    `torch.kthvalue`: on CUDA it reduces each row in one block, 2.5 ms
    for a row of 480,189 users on an H100 against 0.14 ms for `topk`.
    """
    return torch.topk(x, k, dim=-1, largest=False).values[..., k - 1]


def partition_sizes(m: int, omega: int) -> tuple[int, ...]:
    """Sizes of the ω norm-descending partitions of P (Alg. 1 line 3):
    the first (m mod ω) buckets carry one extra item."""
    base = m // omega
    extra = m % omega
    return tuple(base + (1 if l < extra else 0) for l in range(omega))
