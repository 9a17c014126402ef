"""Matrix factorization — the paper's embedding-production step.

Counterpart of `repro/data/mf.py`. §5 of the paper builds user/item
vectors with LIBMF (d = 200) from rating triples; this module reproduces
that substrate so the full pipeline (ratings → embeddings → rank table →
queries) runs end to end in the port.

Mini-batch SGD with bias terms and L2, as the reference: an epoch drops
the tail (`n_obs // batch` batches), batch b takes
`perm[b·batch:(b+1)·batch]`, the loss is
`mean(err²) + l2·(Σ u[i]² + Σ v[j]²)/batch`, and the step is
`p − lr·g` on u, v, bu and bv with g summed over the rows a batch
gathers more than once.

The gradient comes from `torch.autograd` on the gathered rows. The
update is sparse: only rows a batch gathers change, and they change by
exactly the dense step's value (an untouched row's `p − lr·0` is `p`).
Each row's gradient is summed in a fixed order, so training is
deterministic given the seeds: on the card by `index_put_(...,
accumulate=True)`, which sorts the indices (`index_add_` there adds by
atomics, in whatever order they land); on the CPU by `index_add_`, which
adds the rows one after another (`index_put_` there adds by atomics
from several threads).

On the card an epoch's steps replay one CUDA graph: a step is some
seventy launches on batches of 8,192 ratings, so launched one by one the
host sets its pace (12,265 steps an epoch at the Netflix Prize's
100,480,507 ratings). The first step of an epoch runs eagerly on a side
stream, the second is captured and then replayed, as every later one;
each copies its batch's indices and ratings into the graph's input
buffers first. The graph holds the eager step's kernels in its order,
so its result is bitwise the eager one's.

The RNG cannot be the reference's: `init_mf` draws from `seed`, and
epoch e's permutation from `cfg.seed` and e (`train_mf`), as the
reference separates them. `mf_epoch` takes the permutation, so a test can
feed it the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MFConfig:
    d: int = 200
    lr: float = 0.05
    l2: float = 1e-4
    epochs: int = 10
    batch: int = 8192
    seed: int = 0


def init_mf(seed: int, n: int, m: int, cfg: MFConfig, *, device=None
            ) -> dict:
    """u (n, d) and v (m, d) Gaussian scaled by d^-1/2, zero biases, on
    `device` (the CUDA card unless the caller passes device='cpu')."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    s = cfg.d ** -0.5
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "u": torch.randn((n, cfg.d), generator=g, **f32) * s,
        "v": torch.randn((m, cfg.d), generator=g, **f32) * s,
        "bu": torch.zeros((n,), **f32),
        "bv": torch.zeros((m,), **f32),
    }


def _loss(x: torch.Tensor, y: torch.Tensor, r: torch.Tensor, l2: float
          ) -> torch.Tensor:
    """The reference's `loss_fn` on gathered rows x = [u_i, bu_i] and
    y = [v_j, bv_j], each (batch, d + 1)."""
    d = x.shape[1] - 1
    u_i, bu_i, v_j, bv_j = x[:, :d], x[:, d], y[:, :d], y[:, d]
    pred = (u_i * v_j).sum(1) + bu_i + bv_j
    err = pred - r
    reg = l2 * ((u_i ** 2).sum() + (v_j ** 2).sum())
    return (err * err).mean() + reg / x.shape[0]


def _sum_rows(acc: torch.Tensor, idx: torch.Tensor, g: torch.Tensor):
    """acc[idx[k]] += g[k] for every k, in an order fixed by idx (module
    doc)."""
    if acc.is_cuda:
        acc.index_put_((idx,), g, accumulate=True)
    else:
        acc.index_add_(0, idx, g)


def _sgd_step(uv: tuple, acc: tuple, i, j, r, cfg: MFConfig
              ) -> torch.Tensor:
    """One batch on the epoch's working parameters uv = ([u, bu],
    [v, bv]), each (rows, d + 1): the loss's gradient on the gathered
    rows, summed per row into `acc` (all zero between steps), then
    `p − lr·g` on the rows the batch touched. Returns the batch's loss.
    A row's bias rides in its last column, so each row takes one gather,
    one sum and one update; every column's value is that of the separate
    tensors."""
    leaves = [p[idx].requires_grad_() for p, idx in zip(uv, (i, j))]
    with torch.enable_grad():
        loss = _loss(*leaves, r, cfg.l2)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        for p, a, idx, g in zip(uv, acc, (i, j), grads):
            _sum_rows(a, idx, g)
            p.index_put_((idx,), p[idx] - cfg.lr * a[idx])
            a.index_fill_(0, idx, 0.0)
    return loss.detach()


class _Steps:
    """`_sgd_step` on fixed parameters: eager on the CPU; on the card
    eager once on a side stream, then one captured CUDA graph replayed
    from batch buffers (module doc)."""

    def __init__(self, uv: tuple, acc: tuple, cfg: MFConfig, graph: bool):
        self.uv, self.acc, self.cfg = uv, acc, cfg
        self.eager = not (graph and uv[0].is_cuda)
        self.graph = None
        self.loss = None
        self.batch = None

    def __call__(self, i, j, r) -> torch.Tensor:
        if self.eager:
            return _sgd_step(self.uv, self.acc, i, j, r, self.cfg)
        if self.batch is None:
            self.batch = (i.clone(), j.clone(), r.clone())
            dev = i.device
            now = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(now)
            with torch.cuda.stream(side):
                loss = _sgd_step(self.uv, self.acc, *self.batch, self.cfg)
            now.wait_stream(side)
            return loss
        for buf, x in zip(self.batch, (i, j, r)):
            buf.copy_(x)
        if self.graph is None:
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.loss = _sgd_step(self.uv, self.acc, *self.batch,
                                      self.cfg)
        self.graph.replay()
        return self.loss


def mf_epoch(state: dict, ii, jj, rr, perm, cfg: MFConfig, *,
             graph: bool = True) -> tuple[dict, torch.Tensor]:
    """One epoch of mini-batch SGD over permuted rating triples, on the
    device of `state`. Returns the new state (the given one is left
    as it was) and the mean of the batch losses (a 0-d tensor).
    `graph=False` launches every step's kernels one by one on the card
    too: the reference the graph's epoch is held to."""
    dev = state["u"].device
    nb = ii.shape[0] // cfg.batch
    uv = (torch.cat([state["u"], state["bu"][:, None]], 1),
          torch.cat([state["v"], state["bv"][:, None]], 1))
    acc = tuple(torch.zeros_like(p) for p in uv)
    take = torch.as_tensor(perm, device=dev)[:nb * cfg.batch].long()
    ip = torch.as_tensor(ii, device=dev)[take].long()
    jp = torch.as_tensor(jj, device=dev)[take].long()
    rp = torch.as_tensor(rr, device=dev, dtype=torch.float32)[take]
    losses = torch.empty((nb,), dtype=torch.float32, device=dev)
    step = _Steps(uv, acc, cfg, graph)
    for b in range(nb):
        sl = slice(b * cfg.batch, (b + 1) * cfg.batch)
        losses[b] = step(ip[sl], jp[sl], rp[sl])
    d = cfg.d
    return ({"u": uv[0][:, :d].contiguous(), "v": uv[1][:, :d].contiguous(),
             "bu": uv[0][:, d].contiguous(), "bv": uv[1][:, d].contiguous()},
            losses.mean())


def _epoch_permutation(cfg: MFConfig, e: int, n_obs: int, device
                       ) -> torch.Tensor:
    """Epoch e's permutation of the n_obs ratings, from a generator seeded
    by (cfg.seed, e) through a `SeedSequence` (the CPU generator keeps 32
    bits of a seed)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence((cfg.seed, e)).generate_state(
        1)[0]))
    return torch.randperm(n_obs, generator=g, device=device)


def train_mf(seed: int, n: int, m: int, ii, jj, rr, cfg: MFConfig, *,
             device=None) -> tuple[dict, list]:
    """Full MF training loop on `device` (the CUDA card unless the caller
    passes device='cpu'). Returns (state, per-epoch mean losses)."""
    dev = resolve_device(device)
    state = init_mf(seed, n, m, cfg, device=dev)
    ii, jj, rr = (torch.as_tensor(x, device=dev) for x in (ii, jj, rr))
    losses = []
    for e in range(cfg.epochs):
        perm = _epoch_permutation(cfg, e, ii.shape[0], dev)
        state, loss = mf_epoch(state, ii, jj, rr, perm, cfg)
        losses.append(float(loss))
    return state, losses


def embeddings(state: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """(users, items) for the reverse k-ranks engine. Bias terms fold into
    an extra dimension so inner products keep the rating semantics:
    users [u, 1, bu], items [v, bv, 1], d + 2 columns."""
    u, v = state["u"], state["v"]
    ones = lambda k: torch.ones((k, 1), dtype=u.dtype, device=u.device)
    users = torch.cat([u, ones(u.shape[0]), state["bu"][:, None]], dim=1)
    items = torch.cat([v, state["bv"][:, None], ones(v.shape[0])], dim=1)
    return users, items
