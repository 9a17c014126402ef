"""Clustered synthetic embeddings: Gaussian rows plus shared latent cluster
centers, items with a Gaussian norm spread (paper Fig. 2).

A frozen copy of `src/repro_torch/data/pipeline.py::synthetic_embeddings`
as of commit 0ea130a, made on the generator's device. The configuration's
`embeddings` group gives `n_clusters`, `norm_spread` and
`cluster_strength`.
"""
from __future__ import annotations

import torch


def make(g: torch.Generator, cfg: dict) -> dict:
    """users (n, d) and items (m, d), f32, on `g`'s device."""
    emb = cfg["embeddings"]
    n, m, d = cfg["n_users"], cfg["n_items"], cfg["d"]
    dev, f32 = g.device, torch.float32
    strength = emb["cluster_strength"]
    centers = torch.randn((emb["n_clusters"], d), generator=g, device=dev,
                          dtype=f32)
    cu = torch.randint(emb["n_clusters"], (n,), generator=g, device=dev)
    ci = torch.randint(emb["n_clusters"], (m,), generator=g, device=dev)
    users = torch.randn((n, d), generator=g, device=dev, dtype=f32) \
        + strength * centers[cu]
    items = torch.randn((m, d), generator=g, device=dev, dtype=f32) \
        + strength * centers[ci]
    scale = 1.0 + emb["norm_spread"] * torch.randn((m, 1), generator=g,
                                                   device=dev, dtype=f32)
    return {"users": users, "items": items * torch.abs(scale)}
