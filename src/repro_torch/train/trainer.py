"""Training step assembly: loss → grads → AdamW, with microbatch gradient
accumulation.

Counterpart of the reference's `train/trainer.py` without a mesh (the
sharding rules come with the port's sharding). `make_train_step` returns
the function `launch/train.py` runs; the backward pass is autograd.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models.model import Model, make_prefill_step, \
    make_serve_step
from repro_torch.models.transformer import leaves, tree_map
from repro_torch.train.optimizer import AdamWConfig, OptState, \
    adamw_init, adamw_update

__all__ = ["init_train_state", "make_prefill_step", "make_serve_step",
           "make_train_step"]


def _compute_params(params, bf16: bool):
    """The reference's compute copy: every f32 leaf of two or more
    dimensions cast to bf16 ONCE (stacked norm scales included), the rest
    as it is; the layers' own casts are then no-ops. Gradients flow back
    through the cast into the f32 masters."""
    if not bf16:
        return params
    cast = lambda p: (p.to(torch.bfloat16)
                      if p.dtype == torch.float32 and p.ndim >= 2 else p)
    return tree_map(cast, params)


def _value_and_grad(model: Model, params, batch, bf16: bool):
    """(loss, grads): the loss of `batch` at `params` (a 0-d f32 tensor,
    detached) and its gradient with respect to every leaf (a tree of
    tensors of the leaves' dtypes, zeros where a leaf is unused), each in
    a buffer of its own, so that the caller may accumulate in place."""
    with torch.enable_grad():
        masters = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = model.loss_fn(_compute_params(masters, bf16), batch)
        flat = list(leaves(masters))
        got = torch.autograd.grad(loss, flat, allow_unused=True)
    seen, out = set(), []
    for p, g in zip(flat, got):
        if g is None:
            g = torch.zeros_like(p)
        elif g.data_ptr() in seen:
            g = g.clone()
        seen.add(g.data_ptr())
        out.append(g)
    it = iter(out)
    return loss.detach(), tree_map(lambda _: next(it), params)


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    microbatches: int = 1,
                    schedule: Optional[Callable] = None,
                    bf16_compute_params: bool = True):
    """Returns train_step(params, opt_state, batch) → (params, opt_state,
    metrics {"loss", "grad_norm", "lr"}). The parameters and moments are
    updated in place (`adamw_update`).

    Microbatches split the batch's leading dim; each microbatch's loss
    and gradients are taken in order and summed in f32 onto zeros, as the
    reference's scan carry does, then divided by their count.

    bf16_compute_params: cast the f32 masters to a bf16 compute copy once
    a step (`_compute_params`); AdamW's state stays f32 (mixed precision
    with master weights)."""

    def train_step(params, opt_state: OptState, batch: dict):
        if microbatches == 1:
            loss, grads = _value_and_grad(model, params, batch,
                                          bf16_compute_params)
        else:
            def part(i):
                def take(x):
                    b = x.shape[0] // microbatches
                    return x.reshape(microbatches, b, *x.shape[1:])[i]
                return {k: take(v) for k, v in batch.items()}

            loss = grads = None
            for i in range(microbatches):
                li, gi = _value_and_grad(model, params, part(i),
                                         bf16_compute_params)
                if grads is None:
                    # zeros + g: adding +0.0 turns -0.0 into +0.0 and
                    # leaves every other value as it is
                    loss = li + 0.0
                    grads = tree_map(lambda g: g.add_(0.0), gi)
                else:
                    loss = loss + li
                    for a, g in zip(leaves(grads), leaves(gi)):
                        a.add_(g)
                del gi
            n = torch.tensor(float(microbatches), device=loss.device)
            loss = loss / n
            for g in leaves(grads):
                g.div_(n)
        lr_scale = schedule(opt_state.step) if schedule else 1.0
        params, opt_state, om = adamw_update(opt_cfg, grads, opt_state,
                                             params, lr_scale)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def init_train_state(model: Model, generator, device=None
                     ) -> tuple[dict, OptState]:
    """f32 master parameters drawn from `generator` (a seed or a
    torch.Generator) on `device` (the CUDA card unless the caller passes
    device='cpu'), and AdamW's zero state."""
    params = model.init_params(generator, device)
    return params, adamw_init(params)
