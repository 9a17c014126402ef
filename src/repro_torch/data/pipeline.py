"""Synthetic MF-like embeddings, drawn from a `torch.Generator`.

Counterpart of `repro/data/pipeline.py::synthetic_embeddings`: the same
distribution (Gaussian rows plus shared latent clusters, Gaussian item
norm spread, paper Fig. 2); the numbers differ from `jax.random`'s.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device


def synthetic_embeddings(seed: int, n: int, m: int, d: int, *,
                         norm_spread: float = 0.3, n_clusters: int = 32,
                         cluster_strength: float = 1.0, device=None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(users (n, d), items (m, d)) f32, drawn on `device` (the CUDA card
    unless the caller passes device='cpu')."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    f32 = torch.float32
    centers = torch.randn((n_clusters, d), generator=g, device=dev, dtype=f32)
    cu = torch.randint(n_clusters, (n,), generator=g, device=dev)
    ci = torch.randint(n_clusters, (m,), generator=g, device=dev)
    users = torch.randn((n, d), generator=g, device=dev, dtype=f32) \
        + cluster_strength * centers[cu]
    items = torch.randn((m, d), generator=g, device=dev, dtype=f32) \
        + cluster_strength * centers[ci]
    scale = 1.0 + norm_spread * torch.randn((m, 1), generator=g, device=dev,
                                            dtype=f32)
    return users, items * torch.abs(scale)
