"""Model facade: ties a ModelConfig to the init / loss / prefill / decode
functions of `transformer`, plus the two serving steps built on it.

Counterpart of the reference's `models/model.py` and of
`train/trainer.py::make_prefill_step` / `make_serve_step` (which
`repro_torch.train.trainer` re-exports). The sharding specs
(`param_specs`, `cache_specs`, `batch_specs`) come with the port's
sharding.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


class Model:
    """Facade over the functional transformer API for one architecture."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def init_params(self, generator: Union[int, torch.Generator],
                    device=None) -> dict:
        return T.init_params(generator, self.cfg, device)

    def abstract_params(self) -> dict:
        """The parameter tree on the meta device (shapes and dtypes, no
        allocation): the template of a checkpoint's restore."""
        return T.abstract_params(self.cfg)

    def loss_fn(self, params, batch) -> torch.Tensor:
        return T.lm_loss(params, batch, self.cfg)

    def forward_logits(self, params, tokens,
                       frames: Optional[torch.Tensor] = None):
        return T.forward_logits(params, tokens, self.cfg, frames=frames)

    def init_cache(self, batch: int, cache_len: int, device=None) -> dict:
        return T.init_cache(self.cfg, batch, cache_len, device)

    def decode_step(self, params, cache, tokens):
        return T.decode_step(params, cache, tokens, self.cfg)


def make_serve_step(model: Model):
    """Returns serve_step(params, cache, tokens) → (logits, cache): one
    batched decode step."""

    def serve_step(params, cache, tokens):
        return model.decode_step(params, cache, tokens)

    return serve_step


def make_prefill_step(model: Model):
    """Returns prefill(params, batch) → logits over the full sequence."""

    def prefill(params, batch):
        return model.forward_logits(params, batch["tokens"],
                                    frames=batch.get("frames"))

    return prefill
