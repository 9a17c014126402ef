"""Training step assembly: loss → grads → AdamW, with microbatch gradient
accumulation and the model's sharding rules applied while the step runs.

Counterpart of the reference's `train/trainer.py`. `make_train_step`
returns the function `launch/train.py` runs; the backward pass is
autograd. With `rules` (`models.sharding.rules_for`) the parameters,
moments and batch are DTensors on the rules' mesh: the step runs under
`sharding.sharded(rules)`, each gradient is redistributed to its
parameter's placements (the reference's out_shardings), and the loss and
the grad norm come back replicated, so that a host read gives the value
of the whole batch and the whole gradient.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models.model import Model, make_prefill_step, \
    make_serve_step
from repro_torch.models.sharding import AxisRules, is_dtensor, local, \
    replicate, shard, sharded
from repro_torch.models.transformer import leaves, tree_map
from repro_torch.train.optimizer import AdamWConfig, OptState, \
    adamw_init, adamw_update

__all__ = ["init_train_state", "make_prefill_step", "make_serve_step",
           "make_train_step"]


def _compute_params(params, bf16: bool):
    """The reference's compute copy: every f32 leaf of two or more
    dimensions cast to bf16 ONCE (stacked norm scales included), the rest
    as it is; the layers' own casts are then no-ops. Gradients flow back
    through the cast into the f32 masters. A DTensor's cast keeps its
    master's placements (the reference constrains it to them)."""
    if not bf16:
        return params
    cast = lambda p: (p.to(torch.bfloat16)
                      if p.dtype == torch.float32 and p.ndim >= 2 else p)
    return tree_map(cast, params)


def _buffer(t: torch.Tensor) -> tuple:
    """Where this rank's data of t starts: (its storage, its offset). Two
    gradients with one key share a buffer. Fake tensors have no data
    pointer but have both."""
    t = local(t)
    return t.untyped_storage()._cdata, t.storage_offset()


def _value_and_grad(model: Model, params, batch, bf16: bool):
    """(loss, grads): the loss of `batch` at `params` (a 0-d f32 tensor,
    detached) and its gradient with respect to every leaf (a tree of
    tensors of the leaves' dtypes and, for DTensors, placements; zeros
    where a leaf is unused), each in a buffer of its own, so that the
    caller may accumulate in place."""
    with torch.enable_grad():
        masters = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = model.loss_fn(_compute_params(masters, bf16), batch)
        flat = list(leaves(masters))
        got = torch.autograd.grad(loss, flat, allow_unused=True)
    seen, out = set(), []
    for p, g in zip(flat, got):
        if g is None:
            g = torch.zeros_like(p)
        elif is_dtensor(p) and tuple(g.placements) != tuple(p.placements):
            g = g.redistribute(p.device_mesh, p.placements)
        if _buffer(g) in seen:
            g = g.clone()
        seen.add(_buffer(g))
        out.append(g)
    it = iter(out)
    return loss.detach(), tree_map(lambda _: next(it), params)


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    rules: Optional[AxisRules] = None,
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
    with master weights).

    rules: the sharding rules of a mesh (module doc); None runs on plain
    tensors."""

    def train_step(params, opt_state: OptState, batch: dict):
        with sharded(rules):
            return _step(params, opt_state, batch)

    def _step(params, opt_state: OptState, batch: dict):
        if microbatches == 1:
            loss, grads = _value_and_grad(model, params, batch,
                                          bf16_compute_params)
        else:
            def part(i):
                def take(x):
                    b = x.shape[0] // microbatches
                    part = x.reshape(microbatches, b, *x.shape[1:])[i]
                    return shard(part, "batch", *[None] * (part.ndim - 1))
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
        metrics = {"loss": loss, **om}
        return params, opt_state, {k: replicate(v)
                                   for k, v in metrics.items()}

    return train_step


def init_train_state(model: Model, generator, device=None
                     ) -> tuple[dict, OptState]:
    """f32 master parameters drawn from `generator` (a seed or a
    torch.Generator) on `device` (the CUDA card unless the caller passes
    device='cpu'), and AdamW's zero state."""
    params = model.init_params(generator, device)
    return params, adamw_init(params)
