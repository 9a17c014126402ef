"""PyTorch/CUDA port of the approximate reverse k-ranks engine.

Beside the JAX reference package `repro`, with the same layout: Algorithm
1 (`core.rank_table`), the §4.3 query (`core.query`), the exact oracle
and §5 metrics (`core.exact`, `core.metrics`), the backend registry and
engine (`core.backends`, `core.engine`), and hand-written CUDA kernels
for Hopper (`kernels`). Entry points run on the CUDA card unless the
caller passes device='cpu'. Every f32 product is IEEE f32 (no TF32).
"""
from repro_torch.device import ieee_f32, resolve_device
from repro_torch.core.types import QueryResult, RankTable, RankTableConfig
from repro_torch.core.engine import ReverseKRanksEngine

ieee_f32()

__all__ = ["QueryResult", "RankTable", "RankTableConfig",
           "ReverseKRanksEngine", "ieee_f32", "resolve_device"]
