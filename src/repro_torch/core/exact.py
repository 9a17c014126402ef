"""Exact reverse k-ranks (Definitions 1 and 2) — the O(nmd) oracle.

Counterpart of `repro/core/exact.py`. `exact_ranks` goes through
`kernels.ops.exact_ranks`: on a CUDA tensor the K3 kernel, on the CPU
the plain version in user blocks, so the (n, m) score matrix never
exists at once (34 GB at Netflix scale).
"""
from __future__ import annotations

import torch

from repro_torch.core.query import smallest_k
from repro_torch.kernels import ops


def exact_ranks(users: torch.Tensor, items: torch.Tensor, q: torch.Tensor,
                block: int = 4096) -> torch.Tensor:
    """r(q, u, P) = 1 + #{p ∈ P : u·p > u·q} for every user → (n,) int32.
    `block` is the user-block size of the CPU path."""
    return ops.exact_ranks(users, items, q, block=block)


def reverse_k_ranks(users: torch.Tensor, items: torch.Tensor,
                    q: torch.Tensor, k: int, block: int = 4096
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact reverse k-ranks query (Definition 2): the k users with the
    smallest rank, rank-ascending, ties to the lower user index.
    Returns (indices int64, ranks int32)."""
    ranks = exact_ranks(users, items, q, block=block)
    idx = smallest_k(ranks, k)
    return idx, ranks[idx]


def exact_rank_single(u: torch.Tensor, items: torch.Tensor, q: torch.Tensor
                      ) -> torch.Tensor:
    """r(q, u, P) for one user — the literal Definition 1."""
    return 1 + ((items @ u) > torch.dot(u, q)).sum(dtype=torch.int32)
