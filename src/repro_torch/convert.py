"""Carry state across from the JAX reference to the port.

`from_reference` takes the reference's rank table, users, stored users,
items and sample positions/weights as anything `numpy.asarray` accepts
(the tests pass JAX arrays through numpy) and returns the port's tensors
on a given device, so that both packages compute on the same state;
`summary_from_reference` does the same for a pruning `BlockSummary`.

Every array keeps its storage dtype: f32 stays f32, int8 codes stay
int8, and bf16 travels as its 16-bit pattern. NumPy has no bf16 of its
own, so a JAX bf16 array arrives as an extension dtype named "bfloat16";
its bits are viewed as int16 and reinterpreted as `torch.bfloat16`,
without importing the package that defines it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.pruning import BlockSummary
from repro_torch.core.types import RankTable, StoredUsers
from repro_torch.device import resolve_device


class ReferenceState(NamedTuple):
    rank_table: Optional[RankTable]
    users: Optional[torch.Tensor]
    items: Optional[torch.Tensor]
    positions: Optional[torch.Tensor]
    weights: Optional[torch.Tensor]
    stored_users: Optional[StoredUsers] = None


def _f32(x, dev) -> Optional[torch.Tensor]:
    if x is None:
        return None
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)


def _stored(x, dev) -> Optional[torch.Tensor]:
    """An array in its storage dtype: bf16 bit for bit, int8, else f32."""
    if x is None:
        return None
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(dev)
    if a.dtype == np.int8:
        return torch.from_numpy(np.array(a)).to(dev)
    return _f32(a, dev)


def from_reference(rank_table=None, users=None, items=None, positions=None,
                   weights=None, *, stored_users=None,
                   device=None) -> ReferenceState:
    """Convert reference state (numpy-convertible) to port tensors on
    `device` (the CUDA card unless the caller passes device='cpu').
    `rank_table` is anything with the fields of the reference's
    `RankTable` (the five int8 vectors may be absent or None);
    `stored_users` anything with `rows`, `scale` and `row_slack`."""
    dev = resolve_device(device)
    rt = None
    if rank_table is not None:
        vec = lambda f: _f32(getattr(rank_table, f, None), dev)
        rt = RankTable(thresholds=_stored(rank_table.thresholds, dev),
                       table=_stored(rank_table.table, dev),
                       m=int(np.asarray(rank_table.m)),
                       thr_scale=vec("thr_scale"), thr_off=vec("thr_off"),
                       tab_scale=vec("tab_scale"), tab_off=vec("tab_off"),
                       thr_dev=vec("thr_dev"))
    su = None
    if stored_users is not None:
        su = StoredUsers(rows=_stored(stored_users.rows, dev),
                         scale=_f32(stored_users.scale, dev),
                         row_slack=_f32(stored_users.row_slack, dev))
    pos = None
    if positions is not None:
        pos = torch.from_numpy(np.array(positions, dtype=np.int64)).to(dev)
    return ReferenceState(rank_table=rt, users=_f32(users, dev),
                          items=_f32(items, dev), positions=pos,
                          weights=_f32(weights, dev), stored_users=su)


def summary_from_reference(summary, *, device=None) -> BlockSummary:
    """The reference's `BlockSummary` (numpy-convertible fields) as the
    port's, on `device`: f32 sketches and envelopes, int32 row counts,
    m as a Python int; absent optional fields stay None."""
    dev = resolve_device(device)
    f = {name: _f32(getattr(summary, name), dev)
         for name in BlockSummary._fields if name not in ("rows", "m")}
    return BlockSummary(
        rows=torch.from_numpy(np.array(summary.rows, dtype=np.int32)).to(dev),
        m=int(np.asarray(summary.m)), **f)
