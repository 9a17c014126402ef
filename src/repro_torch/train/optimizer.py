"""AdamW with global-norm clipping, and the warmup-cosine schedule.

Counterpart of the reference's `train/optimizer.py`. The state mirrors the
parameter tree (`OptState`: `mu`, `nu`, and `step`, a 0-d int32 tensor on
the parameters' device). The reference's constants are Python doubles
that its weak-typed f32 math rounds once to f32; here they are rounded
once on the host (`_r32`), and every division divides by a tensor.

`adamw_update` writes the new parameters and moments into the tensors it
is given (the counterpart of the reference launcher's buffer donation):
the master weights and two moments of a 2.5 B-parameter model take
30 GB, which a second copy would not fit beside.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Union

import numpy as np
import torch

from repro_torch.models.transformer import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class OptState(NamedTuple):
    mu: dict
    nu: dict
    step: torch.Tensor


def _r32(x: float) -> float:
    """A Python double rounded once to f32 (a weak-typed jnp constant)."""
    return float(np.float32(x))


def _t(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(_r32(x), dtype=torch.float32, device=like.device)


def adamw_init(params) -> OptState:
    zeros = lambda p: tree_map(torch.zeros_like, p)
    dev = next(iter(leaves(params))).device
    return OptState(mu=zeros(params), nu=zeros(params),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares (f32), the leaves
    added in tree order."""
    total = None
    for g in leaves(tree):
        s = torch.sum(torch.square(g.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


def adamw_update(cfg: AdamWConfig, grads, state: OptState, params,
                 lr_scale: Union[torch.Tensor, float] = 1.0):
    """One AdamW step with global-norm clipping, in place on `params` and
    on `state`'s moments. Returns (params, state, metrics) with the new
    step count and metrics {"grad_norm" (before clipping), "lr"}, 0-d f32
    tensors."""
    gnorm = global_norm(grads)
    clip = torch.clamp(_t(cfg.grad_clip, gnorm)
                       / torch.clamp(gnorm, min=_r32(1e-12)), max=1.0)
    step = state.step + 1
    stepf = step.float()
    b1c = 1.0 - torch.pow(_t(cfg.b1, gnorm), stepf)
    b2c = 1.0 - torch.pow(_t(cfg.b2, gnorm), stepf)
    if isinstance(lr_scale, torch.Tensor):
        lr = _t(cfg.lr, gnorm) * lr_scale
    else:
        lr = _t(cfg.lr * lr_scale, gnorm)
    b1, b2 = _r32(cfg.b1), _r32(cfg.b2)
    c1, c2 = _r32(1 - cfg.b1), _r32(1 - cfg.b2)
    eps, wd = _r32(cfg.eps), _r32(cfg.weight_decay)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.mu),
                          leaves(state.nu)):
        g = g.float() * clip
        m.mul_(b1).add_(c1 * g)
        v.mul_(b2).add_(c2 * g * g)
        del g
        upd = m / b1c
        den = v / b2c
        upd /= den.sqrt_().add_(eps)
        del den
        upd += wd * p
        p.sub_((upd.mul_(lr)).to(p.dtype))
        del upd
    return params, OptState(state.mu, state.nu, step), {
        "grad_norm": gnorm, "lr": lr}


def cosine_schedule(step: torch.Tensor, *, warmup: int, total: int,
                    min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup → cosine decay to min_frac (as a multiplier on lr)."""
    s = step.float()
    warm = s / _t(max(warmup, 1), s)
    prog = torch.clamp((s - _r32(warmup)) / _t(max(total - warmup, 1), s),
                       0.0, 1.0)
    cos = _r32(min_frac) + _r32((1 - min_frac) * 0.5) * (
        1.0 + torch.cos(_r32(math.pi) * prog))
    return torch.where(s < _r32(warmup), warm, cos)
