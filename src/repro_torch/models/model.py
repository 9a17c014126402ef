"""Model facade: ties a ModelConfig to the init / loss / prefill / decode
functions of `transformer`, plus the two serving steps built on it.

Counterpart of the reference's `models/model.py` and of
`train/trainer.py::make_prefill_step` / `make_serve_step` (which
`repro_torch.train.trainer` re-exports), with the sharding specs the
launchers need (`param_specs`, `cache_specs`, `batch_specs`).

Spec resolution is path-pattern based: every parameter path maps to
logical axes, resolved against an AxisRules (mesh-specific) table. A spec
is a tuple with one entry per tensor dim (`sharding.AxisRules.spec`); a
stacked segment leaf gets a leading None (the layer axis is never
sharded), a leaf whose rank does not match its rule's is replicated, and
a leaf no rule matches is replicated (the empty spec).
"""
from __future__ import annotations

import re
from typing import Optional, Union

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, ShapeCell
from repro_torch.models.sharding import AxisRules, sharded

# (path regex, logical axes per dim) — first match wins. Paths are
# "/"-joined key sequences, e.g. "segments/0/b0/attn/wq".
_PARAM_RULES = [
    (r"embed/tok$",            ("vocab", None)),
    (r"lm_head/w$",            (None, "vocab")),
    (r"enc_in/w$",             (None, None)),
    (r"(attn|xattn)/wq$",      (None, "qdim")),
    (r"(attn|xattn)/w[kv]$",   (None, "kv_dim")),
    (r"(attn|xattn)/wo$",      ("qdim", None)),
    (r"mlp/w_(gate|up)$",      (None, "hidden")),
    (r"mlp/w_down$",           ("hidden", None)),
    (r"moe/router$",           (None, "experts")),
    (r"moe/w_(gate|up)$",      ("experts", "fsdp", None)),
    (r"moe/w_down$",           ("experts", None, "fsdp")),
    (r"rglru/w_(x|gate)$",     (None, "rnn")),
    (r"rglru/w_out$",          ("rnn", None)),
    (r"rglru/conv_w$",         (None, "rnn")),
    (r"rglru/(conv_b|b_a|b_i|lam)$", ("rnn",)),
    (r"rglru/w_[ai]$",         (None, "rnn")),
    (r"tmix/w_[rkvg]$",        (None, "qdim")),
    (r"tmix/w_o$",             ("qdim", None)),
    (r"tmix/lora_[ab]$",       (None, None)),
    (r"cmix/w_k$",             (None, "hidden")),
    (r"cmix/w_v$",             ("hidden", None)),
    (r"cmix/w_r$",             (None, "qdim")),
]

_CACHE_RULES = [
    (r"/x?[kv]$",              ("batch", "kv_seq", "kv", None)),
    (r"/s$",                   ("batch", "heads", None, None)),
    (r"/(xt|xc)$",             ("batch", None)),
    (r"/h$",                   ("batch", "rnn")),
    (r"/conv$",                ("batch", None, "rnn")),
    (r"len$",                  ()),
]


def _spec_tree(tree, rules_table, ax: AxisRules, stacked_prefixes=(),
               prefix=()):
    """The spec of every leaf of `tree` (dicts and lists; a leaf that is
    not a tensor, such as a cache's `len`, has rank 0), in its shape."""
    if isinstance(tree, dict):
        return {k: _spec_tree(v, rules_table, ax, stacked_prefixes,
                              prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_spec_tree(v, rules_table, ax, stacked_prefixes,
                                     prefix + (str(i),))
                          for i, v in enumerate(tree))
    s = "/".join(prefix)
    ndim = tree.ndim if isinstance(tree, torch.Tensor) else 0
    stacked = any(s.startswith(p) for p in stacked_prefixes)
    for pat, axes in rules_table:
        if re.search(pat, s):
            spec = ax.spec(*axes)
            if ndim == len(axes) + 1 and stacked:
                return (None, *spec)            # leading layer-stack axis
            if ndim != len(axes) and not stacked:
                return ()                       # rank mismatch → replicate
            return spec
    return ()                                   # default: fully replicated


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

    def param_specs(self, ax: AxisRules):
        return _spec_tree(self.abstract_params(), _PARAM_RULES, ax,
                          stacked_prefixes=("segments", "enc_segments"))

    def loss_fn(self, params, batch) -> torch.Tensor:
        return T.lm_loss(params, batch, self.cfg)

    def forward_logits(self, params, tokens,
                       frames: Optional[torch.Tensor] = None):
        return T.forward_logits(params, tokens, self.cfg, frames=frames)

    def init_cache(self, batch: int, cache_len: int, device=None) -> dict:
        return T.init_cache(self.cfg, batch, cache_len, device)

    def abstract_cache(self, batch: int, cache_len: int) -> dict:
        """The decode cache on the meta device (shapes and dtypes, no
        allocation)."""
        return T.init_cache(self.cfg, batch, cache_len, torch.device("meta"))

    def cache_specs(self, ax: AxisRules, batch: int, cache_len: int):
        return _spec_tree(self.abstract_cache(batch, cache_len),
                          _CACHE_RULES, ax, stacked_prefixes=("segments",))

    def decode_step(self, params, cache, tokens):
        return T.decode_step(params, cache, tokens, self.cfg)

    # -------------------------------------------------------------- shapes
    def input_specs(self, cell: ShapeCell) -> dict:
        """Meta-tensor stand-ins for every model input of a cell (int64
        tokens, as the port's pipeline makes them)."""
        cfg = self.cfg
        B, S = cell.global_batch, cell.seq_len
        meta = lambda *shape, dtype=torch.int64: torch.empty(
            shape, dtype=dtype, device="meta")
        if cell.kind in ("train", "prefill"):
            batch = {"tokens": meta(B, S)}
            if cell.kind == "train":
                batch["labels"] = meta(B, S)
            if cfg.family == "encdec":
                batch["frames"] = meta(B, cfg.enc_seq, cfg.d_model,
                                       dtype=torch.float32)
            return batch
        # decode: one new token against a cache holding S-1 tokens
        return {"tokens": meta(B, 1)}

    def batch_specs(self, ax: AxisRules, cell: ShapeCell):
        spec3 = ax.spec("batch", None, None)
        spec2 = ax.spec("batch", None)
        return {name: spec3 if t.ndim == 3 else spec2
                for name, t in self.input_specs(cell).items()}


def make_serve_step(model: Model, rules: Optional[AxisRules] = None):
    """Returns serve_step(params, cache, tokens) → (logits, cache): one
    batched decode step, under `rules` when given (`sharding.sharded`)."""

    def serve_step(params, cache, tokens):
        with sharded(rules):
            return model.decode_step(params, cache, tokens)

    return serve_step


def make_prefill_step(model: Model, rules: Optional[AxisRules] = None):
    """Returns prefill(params, batch) → logits over the full sequence,
    under `rules` when given (`sharding.sharded`)."""

    def prefill(params, batch):
        with sharded(rules):
            return model.forward_logits(params, batch["tokens"],
                                        frames=batch.get("frames"))

    return prefill
