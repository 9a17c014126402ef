"""Synthetic embeddings and ratings, drawn from a `torch.Generator`.

`synthetic_embeddings` is the counterpart of
`repro/data/pipeline.py::synthetic_embeddings`: the same distribution
(Gaussian rows plus shared latent clusters, Gaussian item norm spread,
paper Fig. 2). `synthetic_ratings` is the counterpart of the reference's
function of that name: low-rank ratings on random (user, item) pairs,
the input of the MF trainer (`data.mf`). `zipf_clustered` and
`mid_mixture` are the counterparts of the pruning bench's user regimes
(`benchmarks/common.py`): Zipf-sized tight user clusters in
cluster-contiguous row order, and the same core mixed with an i.i.d.
noise floor and shuffled. `TokenPipeline` is the counterpart of the
reference's deterministic LM token stream. The numbers differ from
`jax.random`'s; the distributions are the same.
"""
from __future__ import annotations

import dataclasses

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


# ratings in one chunk of `ratings_from`: its two (chunk, d_true) f32
# gathers take 256 MiB each at d_true = 16, where the Netflix Prize's
# 100,480,507 ratings at once would take 6.4 GB each
RATINGS_CHUNK = 1 << 22


def ratings_from(ut: torch.Tensor, vt: torch.Tensor, ii: torch.Tensor,
                 jj: torch.Tensor, noise: torch.Tensor, *,
                 chunk: int = RATINGS_CHUNK) -> torch.Tensor:
    """r_k = ut[ii_k]·vt[jj_k] + 0.05·noise_k, (n_obs,) f32, computed
    `chunk` ratings at a time. Each dot product sums its d_true products
    pairwise in a fixed order by elementwise adds (no reduction kernel,
    whose order may follow the shape), so a rating's bits do not depend
    on the chunk it falls in."""
    out = torch.empty(ii.shape, dtype=torch.float32, device=ut.device)
    for s in range(0, ii.shape[0], chunk):
        e = min(s + chunk, ii.shape[0])
        p = ut[ii[s:e]] * vt[jj[s:e]]
        while p.shape[1] > 1:
            h = p.shape[1] // 2
            q = p[:, :h] + p[:, h:2 * h]
            p = torch.cat([q, p[:, 2 * h:]], 1) if p.shape[1] % 2 else q
        out[s:e] = p[:, 0] + 0.05 * noise[s:e]
    return out


def synthetic_ratings(seed: int, n: int, m: int, n_obs: int,
                      d_true: int = 16, *, device=None,
                      chunk: int = RATINGS_CHUNK
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Low-rank ground-truth ratings r_ij = u_i·v_j + ε on a random sample
    of (i, j) pairs — input for the MF trainer. Returns (ii int32, jj
    int32, r f32), each (n_obs,), drawn on `device` (the CUDA card unless
    the caller passes device='cpu') from one generator: the true factors
    ut (n, d_true) and vt (m, d_true), the pairs, then the noise. The
    ratings are computed `chunk` at a time (`ratings_from`), bitwise the
    same for any chunk."""
    dev, g = _generator(seed, device)
    f32 = torch.float32
    ut = torch.randn((n, d_true), generator=g, device=dev,
                     dtype=f32) / d_true ** 0.25
    vt = torch.randn((m, d_true), generator=g, device=dev,
                     dtype=f32) / d_true ** 0.25
    ii = torch.randint(n, (n_obs,), generator=g, device=dev).to(torch.int32)
    jj = torch.randint(m, (n_obs,), generator=g, device=dev).to(torch.int32)
    noise = torch.randn((n_obs,), generator=g, device=dev, dtype=f32)
    return ii, jj, ratings_from(ut, vt, ii, jj, noise, chunk=chunk)


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


# ------------------------------------------------------------ LM tokens
@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    repeat_p: float = 0.3       # P(copy an earlier nearby token)


class TokenPipeline:
    """Deterministic, stateless LM token stream.

    Every batch is a pure function of (seed, step, host_index): it is
    drawn on a CPU `torch.Generator` seeded from those three (through
    numpy's `SeedSequence`), then moved to `device`, so that

      * resume after preemption replays the exact stream (bitwise) — the
        checkpoint only needs to store the step;
      * the stream is the same on the CPU and on the card;
      * host h of H draws its own B/H rows of the step's global batch.

    Tokens follow a Zipf(`zipf_a`) marginal over the vocabulary, drawn by
    inverse CDF (cumulative probabilities in float64, `searchsorted`: no
    (B, S, V) tensor), and with probability `repeat_p` a token copies the
    drawn token 1-7 places before it, so cross-entropy actually decreases
    during the example training runs."""

    def __init__(self, cfg: PipelineConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        ranks = torch.arange(1, cfg.vocab + 1, dtype=torch.float64)
        p = torch.pow(ranks, -cfg.zipf_a)
        self._cdf = torch.cumsum(p / p.sum(), 0)

    def batch_at(self, step: int, host_index: int = 0, host_count: int = 1
                 ) -> dict:
        """{"tokens", "labels"}: (B/host_count, seq_len) int64 on the
        pipeline's device; labels are the tokens shifted by one."""
        cfg = self.cfg
        b, S1 = cfg.global_batch // host_count, cfg.seq_len + 1
        seed = np.random.SeedSequence(
            [cfg.seed, step, host_index]).generate_state(1, np.uint64)[0]
        g = torch.Generator()
        g.manual_seed(int(seed) & ((1 << 63) - 1))
        u = torch.rand((b, S1), generator=g, dtype=torch.float64)
        base = torch.clamp(torch.searchsorted(self._cdf, u, right=True),
                           max=cfg.vocab - 1)
        # short-range repetition: with prob repeat_p, copy token t-Δ
        delta = torch.randint(1, 8, (b, S1), generator=g)
        idx = torch.clamp(torch.arange(S1)[None, :] - delta, min=0)
        copied = torch.gather(base, 1, idx)
        mask = torch.rand((b, S1), generator=g) < cfg.repeat_p
        seq = torch.where(mask, copied, base).to(self.device)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
