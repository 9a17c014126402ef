"""Every input of a run, made on the device from `--seed`.

Users and items come from the module of `embeddings/` that the
configuration's `embeddings.kind` names. `stratified_sample` is a frozen
copy, so that a change to the program cannot move it, of `src/repro_torch/
core/rank_table.py::stratified_sample_indices` (with `types.py::
partition_sizes`) as of commit 0ea130a. The same inputs go to the program
and to the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from rkbench import manifest

# sub-streams of one seed
USERS_ITEMS, SAMPLE, QUERIES, CHECK = 0, 1, 2, 3


def subseed(seed: int, stream: int) -> int:
    """A 63-bit seed for `stream` of a run's `seed` (any whole number)."""
    ss = np.random.SeedSequence([abs(int(seed)), int(seed < 0), stream])
    return int(ss.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, stream))
    return g


def partition_sizes(m: int, omega: int) -> list[int]:
    """Sizes of the ω norm-descending partitions (Alg. 1 line 3): the
    first m mod ω carry one extra item."""
    base, extra = divmod(m, omega)
    return [base + (1 if part < extra else 0) for part in range(omega)]


def stratified_sample(g: torch.Generator, m: int, omega: int, s: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Alg. 1 lines 4-6: s positions without replacement in each norm
    partition, indexing the norm-descending order, and the Eq. (1)
    weights |P_l| / s. Returns (ω·s,) int64 and (ω·s,) f32."""
    pos, w, start = [], [], 0
    for size in partition_sizes(m, omega):
        if s > size:
            local = torch.randint(size, (s,), generator=g, device=g.device)
        else:
            local = torch.randperm(size, generator=g, device=g.device)[:s]
        pos.append(start + local)
        w.append(torch.full((s,), size / s, dtype=torch.float32,
                            device=g.device))
        start += size
    return torch.cat(pos).to(torch.int64), torch.cat(w)


def make(cfg: dict, seed: int, device) -> dict:
    """users, items (and whatever else the embeddings module makes), and
    Algorithm 1's sample (positions, weights) of a configuration."""
    data = manifest.embeddings(cfg["embeddings"]["kind"]).make(
        generator(seed, USERS_ITEMS, device), cfg)
    data["positions"], data["weights"] = stratified_sample(
        generator(seed, SAMPLE, device), cfg["n_items"], cfg["omega"],
        cfg["s"])
    return data
