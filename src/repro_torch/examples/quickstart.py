"""Quickstart: build a rank-table index and answer c-approximate reverse
k-ranks queries (the paper's end-to-end flow in ~40 lines).

    python -m repro_torch.examples.quickstart

Counterpart of the reference's `examples/quickstart.py`, on the CUDA
card; `main(device="cpu", n_users=..., n_items=..., dim=...)` runs it on
the CPU at another size.
"""
import numpy as np

from repro_torch.core import metrics
from repro_torch.core.engine import ReverseKRanksEngine
from repro_torch.core.exact import exact_ranks, reverse_k_ranks
from repro_torch.core.types import RankTableConfig
from repro_torch.data.pipeline import synthetic_embeddings


def main(*, device=None, n_users: int = 10_000, n_items: int = 4_000,
         dim: int = 200, k: int = 10, c: float = 2.0) -> dict:
    users, items = synthetic_embeddings(0, n_users, n_items, dim,
                                        device=device)

    # --- offline: Algorithm 1 (O((n+m)d + m log m), vs QSRP's Ω(nmd)) ----
    engine = ReverseKRanksEngine.build(
        users, items, RankTableConfig(tau=500, omega=10, s=64), 1,
        device=users.device)
    print(f"index built: {engine.memory_bytes() / 2**20:.1f} MiB "
          f"for {n_users:,} users")

    # --- online: O(nd) per query -----------------------------------------
    query_item = items[42 % n_items]
    result = engine.query(query_item, k=k, c=c)
    print(f"top-{k} users for item 42: {result.indices.tolist()}")
    print(f"estimated ranks: {np.round(result.est_rank.cpu().numpy(), 1)}")
    print(f"Lemma-1 closed the search in step 2: {bool(result.guaranteed)} "
          f"(accepted={int(result.n_accepted)}, "
          f"pruned={int(result.n_pruned)})")

    # --- verify against the exact O(nmd) oracle ---------------------------
    truth = exact_ranks(users, items, query_item).cpu().numpy()
    exact_idx, exact_rk = reverse_k_ranks(users, items, query_item, k)
    got, exact_idx = result.indices.cpu().numpy(), exact_idx.cpu().numpy()
    acc = metrics.accuracy(got, exact_idx, truth, c=c)
    ratio = metrics.overall_ratio(got, exact_idx, truth)
    print(f"accuracy={acc:.3f}  overall-ratio={ratio:.3f}  "
          f"(exact best ranks: {exact_rk[:5].tolist()}…)")
    return {"accuracy": acc, "overall_ratio": ratio}


if __name__ == "__main__":
    main()
