"""Carry state across from the JAX reference to the port.

`from_reference` takes the reference's rank table, users, items and
sample positions/weights as anything `numpy.asarray` accepts (the tests
pass JAX arrays through numpy) and returns the port's tensors on a given
device, so that both packages compute on the same state.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.types import RankTable
from repro_torch.device import resolve_device


class ReferenceState(NamedTuple):
    rank_table: Optional[RankTable]
    users: Optional[torch.Tensor]
    items: Optional[torch.Tensor]
    positions: Optional[torch.Tensor]
    weights: Optional[torch.Tensor]


def _f32(x, dev) -> Optional[torch.Tensor]:
    if x is None:
        return None
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)


def from_reference(rank_table=None, users=None, items=None, positions=None,
                   weights=None, *, device=None) -> ReferenceState:
    """Convert reference state (numpy-convertible) to port tensors on
    `device` (the CUDA card unless the caller passes device='cpu').
    `rank_table` is anything with `thresholds`, `table` and `m` fields,
    such as the reference's `RankTable`."""
    dev = resolve_device(device)
    rt = None
    if rank_table is not None:
        rt = RankTable(thresholds=_f32(rank_table.thresholds, dev),
                       table=_f32(rank_table.table, dev),
                       m=int(np.asarray(rank_table.m)))
    pos = None
    if positions is not None:
        pos = torch.from_numpy(np.array(positions, dtype=np.int64)).to(dev)
    return ReferenceState(rank_table=rt, users=_f32(users, dev),
                          items=_f32(items, dev), positions=pos,
                          weights=_f32(weights, dev))
