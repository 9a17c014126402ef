"""Query items drawn uniformly from all items, as in the paper's §5
protocol of random items as queries."""
from __future__ import annotations

import torch


def draw(traffic: dict, data: dict, g: torch.Generator) -> torch.Tensor:
    """(pool_batches, batch) int64 item ids."""
    return torch.randint(data["items"].shape[0],
                         (traffic["pool_batches"], traffic["batch"]),
                         generator=g, device=g.device)
