"""Carry state across from the JAX reference to the port.

`from_reference` takes the reference's rank table, users, stored users,
items and sample positions/weights as anything `numpy.asarray` accepts
(the tests pass JAX arrays through numpy) and returns the port's tensors
on a given device, so that both packages compute on the same state;
`summary_from_reference` does the same for a pruning `BlockSummary`, and
`correction_from_reference`, `base_from_reference`,
`delta_state_from_reference` and `snapshot_from_reference` for the
mutable index (a snapshot's delta correction, sampling state and delta
buffer).

Every array keeps its storage dtype: f32 stays f32, int8 codes stay
int8, and bf16 travels as its 16-bit pattern. NumPy has no bf16 of its
own, so a JAX bf16 array arrives as an extension dtype named "bfloat16";
its bits are viewed as int16 and reinterpreted as `torch.bfloat16`,
without importing the package that defines it.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.pruning import BlockSummary
from repro_torch.core.types import DeltaCorrection, RankTable, \
    RankTableConfig, StoredUsers
from repro_torch.device import resolve_device
from repro_torch.index.delta import BaseIndex, DeltaState
from repro_torch.index.snapshot import IndexSnapshot


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


def _i64(x, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.int64)).to(dev)


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
    pos = None if positions is None else _i64(positions, dev)
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


def correction_from_reference(corr, *, device=None) -> DeltaCorrection:
    """The reference's `DeltaCorrection` as the port's on `device`: the
    score sets in their storage dtype (f32, bf16 bit for bit, int8
    codes), the live mask as bool, m_new as a Python int."""
    dev = resolve_device(device)
    vec = lambda f: _f32(getattr(corr, f), dev)
    return DeltaCorrection(
        add_scores=_stored(corr.add_scores, dev),
        del_scores=_stored(corr.del_scores, dev),
        user_live=torch.from_numpy(np.array(corr.user_live,
                                            dtype=bool)).to(dev),
        m_new=int(np.asarray(corr.m_new)), add_scale=vec("add_scale"),
        add_off=vec("add_off"), del_scale=vec("del_scale"),
        del_off=vec("del_off"))


def base_from_reference(base, art, *, device=None) -> BaseIndex:
    """The reference's `BaseIndex` as the port's on `device`. `art` is the
    reference's `SamplingArtifacts` of that base (its positions and norm
    order, which the reference's `BaseIndex` does not keep)."""
    dev = resolve_device(device)
    return BaseIndex(
        items=_f32(base.items, dev),
        item_ids=np.array(base.item_ids, dtype=np.int64),
        samples=_f32(base.samples, dev), weights=_f32(base.weights, dev),
        weights_host=np.array(base.weights_host, dtype=np.float32),
        sample_ids=np.array(base.sample_ids, dtype=np.int64),
        max_norm=_f32(base.max_norm, dev), positions=_i64(art.positions, dev),
        order=_i64(art.order, dev))


def delta_state_from_reference(delta, *, device=None) -> DeltaState:
    """The reference's `DeltaState` as the port's: host masks and ids
    copied, the inserted vectors as f32 on `device`."""
    dev = resolve_device(device)
    return DeltaState(
        base_live=np.array(delta.base_live, dtype=bool),
        added_ids=np.array(delta.added_ids, dtype=np.int64),
        added_items=_f32(delta.added_items, dev),
        user_live=np.array(delta.user_live, dtype=bool),
        touched_users=frozenset(int(i) for i in delta.touched_users))


def snapshot_from_reference(snap, art=None, *, device=None
                            ) -> IndexSnapshot:
    """The reference's `IndexSnapshot` as the port's on `device`: users,
    table, stored users, delta buffer and correction; its base needs the
    reference's `SamplingArtifacts` `art` (None leaves the base out)."""
    dev = resolve_device(device)
    st = from_reference(snap.rank_table, snap.users,
                        stored_users=snap.stored_users, device=dev)
    base = None
    if snap.base is not None and art is not None:
        base = base_from_reference(snap.base, art, device=dev)
    return IndexSnapshot(
        epoch=int(snap.epoch), users=st.users, rank_table=st.rank_table,
        config=RankTableConfig(**{f.name: getattr(snap.config, f.name)
                                  for f in dataclasses.fields(
                                      RankTableConfig)}),
        base=base,
        delta=delta_state_from_reference(snap.delta, device=dev),
        corr=(None if snap.corr is None
              else correction_from_reference(snap.corr, device=dev)),
        user_remap=(None if snap.user_remap is None
                    else np.array(snap.user_remap, dtype=np.int64)),
        stored_users=st.stored_users)
