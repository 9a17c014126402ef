"""Logical-axis sharding: one place that maps model-internal axis names to
mesh axes, so layer code stays mesh-agnostic.

Counterpart of the reference's `models/sharding.py` over a
`torch.distributed.device_mesh.DeviceMesh` and DTensor placements. Layer
code calls `shard(x, "batch", None, "hidden")`; under an active
`axis_rules` context a DTensor is redistributed to the resolved
placements (what GSPMD's `with_sharding_constraint` makes of it), outside
one, or on a plain tensor, it is the identity.

A spec is a tuple with one entry per tensor dim: a mesh-axis name, a
tuple of names (nested data axes such as ("pod", "data"), which must come
in the mesh's own dim order, as the reference's tables give them), or
None. `placements_for(mesh, spec)` turns it into one placement per mesh
dim: `Shard(tensor_dim)` where the spec names that mesh dim and the dim
has more than one rank, else `Replicate()` (a shard over one rank holds
the whole dim, which JAX counts as replicated; DTensor would refuse to
reshape such a dim). Several mesh dims sharding one tensor dim split it
in mesh-dim order (the first the most major), which is how JAX orders
the devices of a tuple axis.

Rules are computed per (ModelConfig, mesh) by `rules_for`: tensor-parallel
axes fall back to replication when a dimension is not divisible by the
mesh axis (e.g. gemma-2b's 8 heads on a 16-way model axis). `rules_for`
reads only `mesh.mesh_dim_names` and `mesh.shape`.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

_STATE = threading.local()


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def placements_for(mesh, spec: tuple) -> tuple:
    """One DTensor placement per mesh dim for `spec` (see the module
    doc). Raises ValueError where a tuple axis lists mesh dims out of the
    mesh's order or a mesh axis is used twice."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    owner = {}
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        group = axis if isinstance(axis, tuple) else (axis,)
        order = [names.index(a) for a in group]
        if order != sorted(order):
            raise ValueError(f"axis {axis!r} is not in the mesh's dim order "
                             f"{tuple(names)}")
        for a in group:
            if a in owner:
                raise ValueError(f"mesh axis {a!r} used twice in {spec!r}")
            owner[a] = dim
    sizes = _sizes(mesh)
    return tuple(Shard(owner[a]) if a in owner and sizes[a] > 1
                 else Replicate() for a in names)


class AxisRules:
    """mesh + {logical axis name -> mesh axis (possibly a tuple) or None}."""

    def __init__(self, mesh, table: dict):
        self.mesh = mesh
        self.table = dict(table)

    def spec(self, *axes) -> tuple:
        """One entry per dim; a tuple of one mesh axis is that axis, as
        a PartitionSpec normalizes it."""
        one = lambda v: v[0] if isinstance(v, tuple) and len(v) == 1 else v
        return tuple(one(self.table.get(a)) if a else None for a in axes)

    def placements(self, *axes) -> tuple:
        return placements_for(self.mesh, self.spec(*axes))


def current_rules() -> Optional[AxisRules]:
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def axis_rules(rules: Optional[AxisRules]):
    prev = getattr(_STATE, "rules", None)
    _STATE.rules = rules
    try:
        yield
    finally:
        _STATE.rules = prev


@contextlib.contextmanager
def sharded(rules: Optional[AxisRules]):
    """`axis_rules(rules)`; with rules, also DTensor's implicit
    replication, under which a plain tensor that meets a DTensor counts as
    replicated on every rank. The model makes such tensors from shapes
    alone, the same on every rank: the RoPE frequencies and the position
    `arange`s, the causal and window masks, the chunked attention's and
    the chunked CE's running buffers, the recurrent scans' zero states,
    the decode step's positions and validity mask, the sinusoidal
    positions, and the constants of the loss and of AdamW."""
    if rules is None:
        with axis_rules(None):
            yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    with axis_rules(rules), implicit_replication():
        yield


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


class _Constrain(torch.autograd.Function):
    """Redistribute to `want`, and the gradient to `want` too: the
    transpose of a sharding constraint is the same constraint on the
    cotangent (as in JAX), which keeps DTensor's backward from choosing
    layouts it then cannot propagate. The gradient then goes on in the
    input's placements, as DTensor's own redistribution hands it back,
    so that the ops before the constraint see the layouts they made."""

    @staticmethod
    def forward(ctx, x, mesh, want):
        from torch.distributed.tensor import Replicate
        ctx.mesh, ctx.want = mesh, want
        # a layout only: a partial sum's gradient is held replicated
        ctx.given = tuple(Replicate() if p.is_partial() else p
                          for p in x.placements)
        if tuple(x.placements) == want:
            return x.view_as(x)
        return x.redistribute(mesh, want)

    @staticmethod
    def backward(ctx, g):
        for placements in (ctx.want, ctx.given):
            if tuple(g.placements) != placements:
                g = g.redistribute(ctx.mesh, placements)
        return g, None, None


def shard(x: torch.Tensor, *axes) -> torch.Tensor:
    """Constrain x's placements (and its gradient's) by logical axis
    names (None = replicated dim): the identity without active rules or
    on a plain tensor."""
    rules = current_rules()
    if rules is None or not is_dtensor(x):
        return x
    return _Constrain.apply(x, rules.mesh, rules.placements(*axes))


def replicate(x: torch.Tensor) -> torch.Tensor:
    """x with every mesh dim replicated: what GSPMD does to the operands
    of an operator it cannot partition. The identity on a plain tensor or
    a replicated DTensor."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    want = (Replicate(),) * x.device_mesh.ndim
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def on_replicas(fn, *args):
    """fn(*args) where fn applies operators that DTensor has no sharding
    rule for (a stable sort, a boolean mask, column writes): each DTensor
    argument is replicated first (`replicate`: an all-gather where it was
    sharded, as GSPMD does for such an operator), fn runs on the full
    local values, the same on every rank, and each tensor it returns
    comes back as a replicated DTensor. Gradients flow through both
    conversions. Without DTensor arguments it is fn(*args)."""
    meshes = [a.device_mesh for a in args if is_dtensor(a)]
    if not meshes:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate
    mesh = meshes[0]
    out = fn(*(replicate(a).to_local() if is_dtensor(a) else a
               for a in args))
    wrap = lambda t: (DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                         run_check=False)
                      if isinstance(t, torch.Tensor) else t)
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def distribute(x: torch.Tensor, mesh, spec: tuple) -> torch.Tensor:
    """A DTensor of `x`'s full value, held the same on every rank, on
    `mesh` with `spec`'s placements: each rank keeps its own slice, no
    collective is made."""
    return _place(x, mesh, placements_for(mesh, spec))


def local(x: torch.Tensor) -> torch.Tensor:
    """The tensor this rank holds: a DTensor's local shard, else x."""
    return x.to_local() if is_dtensor(x) else x


def split_dim(x: torch.Tensor, dim: int, sizes: tuple) -> torch.Tensor:
    """x with `dim` split into `sizes` (a reshape). A DTensor keeps its
    sharding of that dim only where the shards fall on whole rows of
    sizes[0] (its shard count divides sizes[0]: e.g. query heads split
    into KV heads and groups); else the dim is replicated first, as
    GSPMD reshards it — DTensor cannot split such a dim."""
    shape = (*x.shape[:dim], *sizes, *x.shape[dim + 1:])
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        mesh = x.device_mesh
        n = 1
        for i, p in enumerate(x.placements):
            if isinstance(p, Shard) and p.dim == dim:
                n *= mesh.size(i)
        if n > 1 and sizes[0] % n:
            x = x.redistribute(mesh, [
                Replicate() if isinstance(p, Shard) and p.dim == dim else p
                for p in x.placements])
    return x.reshape(shape)


def is_sharded(x: torch.Tensor, dim: int) -> bool:
    """True where x is a DTensor whose `dim` some mesh dim splits."""
    if not is_dtensor(x):
        return False
    from torch.distributed.tensor import Shard
    return any(isinstance(p, Shard) and p.dim == dim for p in x.placements)


def local_range(x: torch.Tensor, dim: int) -> tuple:
    """(start, size) of the part of DTensor x's `dim` this rank holds:
    each mesh dim that shards it splits the range left to it the way
    torch.chunk does, in mesh-dim order."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    start, size = 0, x.shape[dim]
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            step = -(-size // mesh.size(i))
            lo = min(coord[i] * step, size)
            start, size = start + lo, min(step, size - lo)
    return start, size


def _like_but(x: torch.Tensor, dim: int) -> list:
    """x's placements for a tensor without x's `dim`: that dim's shards
    replicated, later dims' shards moved down by one."""
    from torch.distributed.tensor import Replicate, Shard
    return [Replicate() if isinstance(p, Shard) and p.dim == dim
            else Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > dim
            else p for p in x.placements]


def pick_last(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x[..., index] per row: torch.gather(x, -1, index[..., None])[..., 0].
    Where a mesh shards x's last dim (the vocabulary of the logits), each
    rank picks from its own slice (0 where the index lies outside it) and
    the picks are summed across the shards: the gradient then stays in
    each rank's slice, where DTensor's gather would build it over the
    whole dim on every rank."""
    last = x.ndim - 1
    if not is_sharded(x, last):
        return torch.gather(x, -1, index[..., None])[..., 0]
    from torch.distributed.tensor import DTensor, Partial, Shard
    mesh = x.device_mesh
    want = _like_but(x, last)
    index = (index.redistribute(mesh, want) if is_dtensor(index) else
             _place(index, mesh, want)).to_local()
    start, size = local_range(x, last)
    local = index - start
    inside = (local >= 0) & (local < size)
    got = torch.gather(x.to_local(), -1, local.clamp(0, size - 1)[..., None])
    got = torch.where(inside, got[..., 0], 0.0)
    part = [Partial() if isinstance(p, Shard) and p.dim == last else q
            for p, q in zip(x.placements, want)]
    shape = x.shape[:-1]
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(got, mesh, part, run_check=False, shape=shape,
                              stride=stride).redistribute(mesh, want)


def take_rows(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """table[index] (an embedding lookup: table (V, d), integer index).
    Where a mesh splits the index or the table's rows, each rank looks up
    its own index shard in its own slice of rows (0 where a row lies
    outside it) and the lookups are summed across the table's shards —
    the vocabulary-parallel embedding, whose gradient stays in each
    rank's slice. DTensor's own index rule cannot take an index dim split
    by two mesh dims (("pod", "data") on the batch) in every torch
    release."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    split = lambda t: is_dtensor(t) and any(isinstance(p, Shard)
                                            for p in t.placements)
    if not (split(table) or split(index)):
        return table[index]
    mesh = (table if is_dtensor(table) else index).device_mesh
    rows_split = [is_dtensor(table) and isinstance(p, Shard) and p.dim == 0
                  for p in (table.placements if is_dtensor(table)
                            else [Replicate()] * mesh.ndim)]
    tp = [Shard(0) if r else Replicate() for r in rows_split]
    table = (table.redistribute(mesh, tp) if is_dtensor(table)
             and list(table.placements) != tp else table)
    if not is_dtensor(table):
        table = _place(table, mesh, tp)
    ip = ([Replicate()] * mesh.ndim if not is_dtensor(index) else
          [Replicate() if r or not isinstance(p, (Shard, Replicate)) else p
           for r, p in zip(rows_split, index.placements)])
    index = (index.redistribute(mesh, ip) if is_dtensor(index) else
             _place(index, mesh, ip))
    start, size = local_range(table, 0)
    local = index.to_local() - start
    inside = (local >= 0) & (local < size)
    # a mesh dim that splits the index but not the rows holds the table
    # whole on each rank, which looks up its own indices: the table's
    # gradient there is each rank's share of a sum
    grad = [Partial() if not r and isinstance(p, Shard) else q
            for r, p, q in zip(rows_split, ip, tp)]
    rows = table.to_local(grad_placements=grad)[local.clamp(0, size - 1)]
    rows = torch.where(inside[..., None], rows, torch.zeros(
        (), dtype=rows.dtype, device=rows.device))
    part = [Partial() if r else p for r, p in zip(rows_split, ip)]
    want = [Replicate() if r else p for r, p in zip(rows_split, ip)]
    shape = (*index.shape, table.shape[1])
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(rows, mesh, part, run_check=False, shape=shape,
                              stride=stride).redistribute(mesh, want)


def _place(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """A DTensor of `x`'s full value, held the same on every rank, with
    `placements` (`src_data_rank=None`: each rank slices its own)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, mesh, list(placements), src_data_rank=None)


def write_slot(cache: torch.Tensor, slot: int, value: torch.Tensor) -> None:
    """cache[:, slot] = value, in place (a decode step's new K or V row).
    On a DTensor cache whose dim 1 (time) is sharded, the rank that holds
    `slot` writes it into its shard, the others write nothing, as GSPMD's
    dynamic update slice does; `value` is first brought to the cache's
    placements of the other dims."""
    if not is_dtensor(cache):
        cache[:, slot] = value
        return
    mesh = cache.device_mesh
    want = _like_but(cache, 1)
    if is_dtensor(value):
        if list(value.placements) != want:
            value = value.redistribute(mesh, want)
        value = value.to_local()
    else:
        value = _place(value, mesh, want).to_local()
    start, size = local_range(cache, 1)
    if start <= slot < start + size:
        cache.to_local()[:, slot - start] = value


def per_shard(fn, roles: tuple, out: object, *args):
    """fn(*args) on each rank's slices, as `shard_map` runs it, for a fn
    that is independent along some dims of its arguments (attention along
    the batch and the heads, RWKV's scan along the batch and the heads).

    roles: one string per argument naming each dim's role by a letter
    ("b", "h", ...; "." for a dim that must stay whole), or None for an
    argument passed as it is. A mesh dim keeps splitting the role the
    first argument's placement gives it; every argument is brought to
    that layout (sharded where it has the role, replicated elsewhere) and
    fn runs on the local tensors. out: the role string of fn's result, or
    a tuple of them for a tuple of results, each wrapped back as a
    DTensor. Without DTensor arguments it is fn(*args). DTensor would
    otherwise merge two sharded dims into one bmm batch dim, which it
    cannot propagate."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    first = args[0]
    mesh = first.device_mesh
    role = [roles[0][p.dim] if isinstance(p, Shard) and roles[0][p.dim]
            != "." else None for p in first.placements]
    place = lambda rs: [Shard(rs.index(r)) if r is not None and r in rs
                        else Replicate() for r in role]
    local = []
    for a, rs in zip(args, roles):
        if rs is None:
            local.append(a)
            continue
        want = place(rs)
        if is_dtensor(a):
            if list(a.placements) != want:
                a = a.redistribute(mesh, want)
            # an argument without a role that the mesh splits is whole on
            # each rank, where fn meets the others' slices: its gradient
            # is each rank's share of a sum
            grad = [Partial() if r is not None and r not in rs else p
                    for r, p in zip(role, want)]
            local.append(a.to_local(grad_placements=grad))
        else:
            local.append(_place(a, mesh, want).to_local())
    got = fn(*local)

    def wrap(t, rs):
        want = place(rs)
        shape = list(t.shape)
        for i, p in enumerate(want):
            if isinstance(p, Shard):
                shape[p.dim] *= mesh.size(i)
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(t.contiguous(), mesh, want, run_check=False,
                                  shape=torch.Size(shape), stride=stride)

    if isinstance(out, tuple):
        return tuple(wrap(t, rs) for t, rs in zip(got, out))
    return wrap(got, out)


_ATTENTION = ("b.kg.", "b.k.", "b.k.")     # q (B,S,KV,G,hd), k, v (B,T,KV,hd)


def per_head_shard(fn, q, k, v, *rest):
    """An attention core fn(q, k, v, *rest) → (B, S, KV, G, hd) on each
    rank's slices of the batch, the KV heads and the query groups
    (`per_shard`); `rest` (masks) passes as it is."""
    return per_shard(fn, _ATTENTION + (None,) * len(rest), "b.kg.",
                     q, k, v, *rest)


def _divisible(n: int, mesh, axis) -> bool:
    if axis is None:
        return True
    names = axis if isinstance(axis, tuple) else (axis,)
    sizes = _sizes(mesh)
    size = 1
    for a in names:
        size *= sizes[a]
    return n % size == 0


def rules_for(cfg, mesh, *, data_axes=("pod", "data"),
              model_axis="model", batch_size: Optional[int] = None,
              fsdp: bool = True) -> AxisRules:
    """Resolve logical axes for a ModelConfig on a mesh.

    Logical axes:
      batch   — DP over pod×data
      seq     — sequence sharding (off by default)
      embed   — d_model (replicated)
      hidden  — FFN hidden / fused q-dim (TP)
      heads   — attention head axis (TP when divisible)
      kv      — KV head axis (TP when divisible)
      vocab   — embedding/logits vocab dim (TP)
      experts — MoE expert dim (EP on the model axis)
      rnn     — RG-LRU / state width (TP when divisible)
    """
    present = set(mesh.mesh_dim_names)
    data = tuple(a for a in (data_axes if isinstance(data_axes, tuple)
                             else (data_axes,)) if a in present)
    model = model_axis if model_axis in present else None
    tp = (lambda n: model if (model and _divisible(n, mesh, model)) else None)
    if batch_size is not None and data and not _divisible(
            batch_size, mesh, data):
        data = ()    # e.g. long_500k's global_batch=1: replicate batch
    table = {
        "batch": data if data else None,
        "seq": None,
        "embed": None,
        "hidden": tp(cfg.d_ff) if cfg.d_ff else None,
        "qdim": tp(cfg.q_dim),
        "heads": tp(cfg.n_heads),
        "kv": tp(cfg.n_kv_heads),
        "kv_dim": tp(cfg.kv_dim),
        "vocab": tp(cfg.vocab),
        "experts": tp(cfg.n_experts) if cfg.n_experts else None,
        "moe_hidden": tp(cfg.moe_d_ff) if cfg.moe_d_ff else None,
        "rnn": tp(cfg.lru_width) if cfg.family == "hybrid" else None,
        # ZeRO/FSDP axis for the huge expert weights: shard d_model over
        # the data axes so params and AdamW state fit device memory
        "fsdp": (data if (fsdp and data and _divisible(cfg.d_model, mesh,
                                                       data)) else None),
        # decode-cache sequence sharding: where the KV heads cannot span
        # the model axis, shard the cache's TIME axis over it instead
        "kv_seq": (model if (model and not _divisible(cfg.n_kv_heads, mesh,
                                                      model)) else None),
    }
    return AxisRules(mesh, table)
