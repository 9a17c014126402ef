"""Pluggable query-execution backends (static index only).

Counterpart of `repro/core/backends.py`, with two registered backends:

  "dense" — plain PyTorch step 1 (`core.query`): one (n, d)×(d, B)
            product plus one pass over the table per batch;
  "fused" — step 1 in a kernel (`kernels.ops.bound_ranks_batched_stored`:
            K1 on an f32 table, K4 on bf16, K5 on int8) on CUDA
            tensors; its plain version on CPU tensors.

`users` is the raw (n, d) matrix at f32 storage and `StoredUsers` at
bf16 and int8.

`bound_ranks` takes a (B, d) block and returns (B, n) bounds; `select`
realizes §4.3 steps 2-3; `query_batch` composes the two. Wrapper specs
`"<prefix>:<inner>"` resolve through `register_wrapper`; none is
registered yet, so such a spec raises like an unknown name.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Type

import torch

from repro_torch.core import query as query_mod
from repro_torch.core import rank_table as rt_mod
from repro_torch.core.types import QueryResult, RankTable, RankTableConfig
from repro_torch.kernels import ops


class QueryBackend:
    """Base class / protocol for batched query execution."""

    name: str = "abstract"

    def bound_ranks(self, rt: RankTable, users: torch.Tensor,
                    qs: torch.Tensor):
        """§4.3 step 1 for a (B, d) block → (r↓, r↑, est), each (B, n)."""
        raise NotImplementedError

    def select(self, rt: RankTable, r_lo, r_up, est, *, k: int,
               c: float) -> QueryResult:
        """§4.3 steps 2-3 on (B, n) bounds."""
        return query_mod.select_topk(r_lo, r_up, est, k=k, c=c,
                                     m_items=rt.m)

    def build_index(self, users: torch.Tensor, items: torch.Tensor,
                    cfg: RankTableConfig,
                    generator: Optional[torch.Generator] = None, *,
                    positions=None, weights=None) -> RankTable:
        """Algorithm 1 on this backend's substrate."""
        return rt_mod.build_rank_table(users, items, cfg, generator,
                                       positions=positions, weights=weights)

    def query_batch(self, rt: RankTable, users: torch.Tensor,
                    qs: torch.Tensor, *, k: int, c: float) -> QueryResult:
        r_lo, r_up, est = self.bound_ranks(rt, users, qs)
        return self.select(rt, r_lo, r_up, est, k=k, c=c)


_REGISTRY: Dict[str, Type[QueryBackend]] = {}
_WRAPPERS: Dict[str, Callable[[str], QueryBackend]] = {}


def register_backend(name: str):
    """Class decorator: register a QueryBackend under `name`."""
    def deco(cls: Type[QueryBackend]) -> Type[QueryBackend]:
        if "name" not in cls.__dict__:
            cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def register_wrapper(prefix: str):
    """Register `factory(inner_name) -> QueryBackend` under `prefix`,
    making `"<prefix>:<inner>"` a resolvable backend spec."""
    def deco(factory):
        _WRAPPERS[prefix] = factory
        return factory
    return deco


def available_backends() -> list[str]:
    return sorted(_REGISTRY)


def get_backend(spec) -> QueryBackend:
    """Resolve a registered name, a `"<wrapper>:<inner>"` spec, or an
    already-built instance; anything else raises ValueError."""
    if isinstance(spec, QueryBackend):
        return spec
    if isinstance(spec, str) and ":" in spec:
        prefix, _, inner = spec.partition(":")
        factory = _WRAPPERS.get(prefix)
        if factory is None:
            raise ValueError(f"unknown backend wrapper {prefix!r} in "
                             f"{spec!r}; registered: {sorted(_WRAPPERS)}")
        return factory(inner)
    try:
        cls = _REGISTRY[spec]
    except (KeyError, TypeError):
        raise ValueError(f"unknown query backend {spec!r}; available: "
                         f"{available_backends()}") from None
    obj = cls()
    obj.name = spec
    return obj


@register_backend("dense")
class DenseBackend(QueryBackend):
    """Plain PyTorch step 1."""

    def bound_ranks(self, rt, users, qs):
        return query_mod.bound_ranks_batch(rt, users, qs)


@register_backend("fused")
class FusedBackend(QueryBackend):
    """Step 1 in the K1, K4 or K5 kernel on CUDA tensors."""

    def bound_ranks(self, rt, users, qs):
        return ops.bound_ranks_batched_stored(users, qs.contiguous(), rt)
