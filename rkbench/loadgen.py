"""The one traffic generator: it reads a mix's parameters
(`traffic/<name>.json`) and draws the query batches from the run's seed.

Parameters: `batch` (queries a batch), `query_items` (the module of
`queries/` that draws the item ids: "uniform" for the paper's §5
protocol of random items as queries), `pool_batches` (batches drawn; the
loop cycles through them), `k` and `c` (the query's), `loop` (the module
of `loops/` that drives the window), `warmup_batches`, `check_batches`
(answers compared with the reference, drawn from the seed among the
window's) and `trace_batches` (the traced slice).
"""
from __future__ import annotations

import torch

from rkbench import inputs, manifest


def query_pool(traffic: dict, data: dict, seed: int) -> torch.Tensor:
    """(P, B, d): the query batches' vectors, gathered in set-up so that a
    batch of the window is a view and launches nothing."""
    items = data["items"]
    g = inputs.generator(seed, inputs.QUERIES, items.device)
    ids = manifest.queries(traffic["query_items"]).draw(traffic, data, g)
    return items[ids].contiguous()
