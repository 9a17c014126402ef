"""The yardstick: the H100's peaks and the pieces of a batch's least bytes
that every storage shares. The storage-specific counts are in
`storage/<name>.py`.

Frozen copies, so that a change to the program cannot move them:
`search_bytes` and `gather_bytes` are `chip_smoke.py::search_bytes` and
`::gather_bytes`, and the peaks its `HBM_BYTES_PER_S` / `FP32_FLOP_PER_S`,
all as of commit 0ea130a.
"""
from __future__ import annotations

import math

import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet, at 700 W
FP32_FLOP_PER_S = 67e12         # H100 SXM, f32 outside the tensor cores
ANSWER_BYTES = 8 + 4            # an int64 user id and its f32 estimate


def search_bytes(row_bytes: int, nb: int) -> int:
    """Least bytes a search of one user's sorted row reads for nb
    queries: a binary search over the row's 32-byte sectors touches
    ⌈log2(sectors)⌉ + 1 of them per query (a query's two keys share
    theirs), and no more than the whole row."""
    return min(row_bytes, nb * (math.ceil(math.log2(row_bytes / 32)) + 1)
               * 32)


def gather_bytes(idx_hi: torch.Tensor, tau: int, elem: int,
                 idx_lo: torch.Tensor | None = None) -> int:
    """Bytes of the distinct 32-byte sectors of an (n, tau) table of
    `elem`-byte values that the lookups at (n, B) bucketize indices read:
    T[idx_lo - 1] where idx_lo > 0 and T[idx_hi] where idx_hi < tau
    (idx_lo defaults to idx_hi, as in the f32 lookup)."""
    idx_lo = idx_hi if idx_lo is None else idx_lo
    base = torch.arange(idx_hi.shape[0], device=idx_hi.device)[:, None] * tau
    cells = torch.cat([(base + idx_lo - 1)[idx_lo > 0],
                       (base + idx_hi)[idx_hi < tau]])
    return 32 * int(torch.unique(cells * elem // 32).numel())


def least_seconds(nbytes: float, flops: float) -> float:
    """The least time on the card: the larger of the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)
