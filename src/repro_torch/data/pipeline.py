"""Synthetic embeddings, drawn from a `torch.Generator`.

`synthetic_embeddings` is the counterpart of
`repro/data/pipeline.py::synthetic_embeddings`: the same distribution
(Gaussian rows plus shared latent clusters, Gaussian item norm spread,
paper Fig. 2). `zipf_clustered` and `mid_mixture` are the counterparts
of the pruning bench's user regimes (`benchmarks/common.py`): Zipf-sized
tight user clusters in cluster-contiguous row order, and the same core
mixed with an i.i.d. noise floor and shuffled. The numbers differ from
`jax.random`'s; the distributions are the same.
"""
from __future__ import annotations

import numpy as np
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


def _generator(seed: int, device) -> tuple[torch.device, torch.Generator]:
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return dev, g


def _zipf_clustered(g: torch.Generator, dev, n: int, m: int, d: int):
    """The clustered regime's draw; its constants are the reference
    bench's (Zipf exponent 1.1, center scale 2, user spread 0.05, item
    spread 0.5)."""
    n_clusters = max(8, min(64, n // 4096))
    w = np.arange(1, n_clusters + 1, dtype=np.float64) ** -1.1
    w /= w.sum()
    counts = np.floor(w * n).astype(np.int64)
    counts[0] += n - counts.sum()
    f32 = torch.float32
    centers = torch.randn((n_clusters, d), generator=g, device=dev,
                          dtype=f32) * 2.0
    assign = torch.repeat_interleave(
        torch.arange(n_clusters, device=dev),
        torch.from_numpy(counts).to(dev))
    users = centers[assign] + 0.05 * torch.randn(
        (n, d), generator=g, device=dev, dtype=f32)
    icl = torch.multinomial(torch.from_numpy(w).to(device=dev, dtype=f32),
                            m, replacement=True, generator=g)
    items = centers[icl] + 0.5 * torch.randn(
        (m, d), generator=g, device=dev, dtype=f32)
    return users, items, icl


def zipf_clustered(seed: int, n: int, m: int, d: int, *, device=None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Zipf-sized Gaussian user clusters (cluster c holds a share
    ∝ (c+1)^-1.1 of the users) in cluster-contiguous row order, tight
    (spread 0.05) around centers of scale 2; items near the same centers
    with Zipf popularity and spread 0.5. The cluster count grows with n
    (n // 4096, in [8, 64]). Returns (users (n, d), items (m, d), item
    cluster (m,)), drawn on `device` (the CUDA card unless the caller
    passes device='cpu')."""
    dev, g = _generator(seed, device)
    return _zipf_clustered(g, dev, n, m, d)


def mid_mixture(seed: int, n: int, m: int, d: int, *, device=None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The mid-entropy user regime: a `zipf_clustered` core of 90 % of
    the users plus an i.i.d. Gaussian noise floor of scale 2, shuffled in
    row order, so that the stored order carries no cluster structure (a
    k-means reorder recovers it for the core). Items and their clusters
    come from the clustered core. Returns (users, items, item cluster)."""
    dev, g = _generator(seed, device)
    n_core = int(round(n * 0.9))
    core, items, icl = _zipf_clustered(g, dev, n_core, m, d)
    noise = 2.0 * torch.randn((n - n_core, d), generator=g, device=dev,
                              dtype=torch.float32)
    users = torch.cat([core, noise])
    users = users[torch.randperm(n, generator=g, device=dev)]
    return users, items, icl
