"""Item-centric retrieval serving: the full paper pipeline — ratings →
matrix factorization → rank-table index → ONLINE c-approximate reverse
k-ranks serving → §5 metrics.

    python -m repro_torch.examples.serve_retrieval

Counterpart of steps 1-3 of the reference's `examples/serve_retrieval.py`,
on the CUDA card; `main(device="cpu", n_users=..., n_items=...,
n_ratings=...)` runs it on the CPU at another size. The reference's step
4 (backbone-encoded embeddings, to show that the engine composes with
the assigned architectures) needs the LM substrate, whose port is ROADMAP
queue 1 item 14; it is not here.

Serving model (repro_torch.serve): queries arrive one at a time and are
`submit()`-ed to a MicroBatcher, which coalesces them into max_batch-
sized ticks dispatched through the engine — one rank-table pass per
tick. `max_wait_ms` is the latency-vs-throughput knob: it caps how long
a PARTIAL tick waits for more arrivals before dispatching (padded to the
batch shape). The "cached:<inner>" backend wrapper adds within-tick
duplicate dedupe and a cross-tick per-query LRU for hot items.
"""
import time

import numpy as np
import torch

from repro_torch.core import metrics
from repro_torch.core.engine import ReverseKRanksEngine
from repro_torch.core.exact import exact_ranks, reverse_k_ranks
from repro_torch.core.types import RankTableConfig
from repro_torch.data.mf import MFConfig, embeddings, train_mf
from repro_torch.data.pipeline import synthetic_ratings
from repro_torch.device import resolve_device
from repro_torch.serve import MicroBatcher


def main(*, device=None, n_users: int = 6_000, n_items: int = 2_500,
         n_ratings: int = 300_000, k: int = 10, c: float = 2.0) -> dict:
    dev = resolve_device(device)

    # --- 1. ratings → MF embeddings (the paper's LIBMF step) -------------
    ii, jj, rr = synthetic_ratings(0, n_users, n_items, n_obs=n_ratings,
                                   device=dev)
    # mean-loss SGD scales the per-example step by 1/batch ⇒ lr = O(10) here
    state, losses = train_mf(0, n_users, n_items, ii, jj, rr,
                             MFConfig(d=64, epochs=8, lr=10.0), device=dev)
    users, items = embeddings(state)
    print(f"MF: rmse-ish loss {losses[0]:.4f} → {losses[-1]:.4f}, "
          f"embeddings d={users.shape[1]}")

    # --- 2. offline index -------------------------------------------------
    # backend= selects a query-execution backend from the registry
    # (repro_torch.core.backends): "dense" (plain torch), "fused" (the
    # CUDA kernels), "sharded", or a wrapped spec — "cached:dense" dedupes
    # duplicate queries within a tick and LRU-caches per-query results
    # across ticks (hot promoted items are answered without touching the
    # rank table).
    eng = ReverseKRanksEngine.build(users, items,
                                    RankTableConfig(tau=500, omega=10, s=64),
                                    1, backend="cached:dense", device=dev)

    # --- 3. async online serving -----------------------------------------
    # Single queries are submitted to the MicroBatcher as they "arrive";
    # ticks of up to max_batch dispatch through the engine, which reads
    # the (n, τ) rank table ONCE per tick. max_wait_ms caps how long a
    # partial tick waits to fill.
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    qs = items[torch.randint(n_items, (16,), generator=g, device=dev)]
    # warm-up builds the tick shape with PERTURBED queries (different
    # cache keys), so the timed burst below exercises the real
    # micro-batched dispatch path, not 16 LRU hits of the warm-up's
    # results.
    eng.query_batch(qs * (1.0 + 1e-6), k=k, c=c)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)     # before the MicroBatcher starts
    qs_host = qs.cpu().numpy()
    with MicroBatcher(eng, max_batch=16, max_wait_ms=2.0) as mb:
        t0 = time.time()
        futs = [mb.submit(q, k, c) for q in qs_host]   # one burst
        results = [f.result() for f in futs]
        wall = time.time() - t0
        print(f"served {len(futs)} queries in {wall*1e3:.1f} ms wall "
              f"({eng.backend_name} backend): {mb.stats()}")

    accs, ratios = [], []
    for b in range(8):
        q = qs[b]
        truth = exact_ranks(users, items, q).cpu().numpy()
        ex_idx = reverse_k_ranks(users, items, q, k)[0].cpu().numpy()
        got = results[b].indices.numpy()
        accs.append(metrics.accuracy(got, ex_idx, truth, c))
        ratios.append(metrics.overall_ratio(got, ex_idx, truth))
    print(f"accuracy {np.mean(accs):.3f}  overall-ratio {np.mean(ratios):.3f}")
    return {"losses": losses, "accuracy": float(np.mean(accs)),
            "overall_ratio": float(np.mean(ratios))}


if __name__ == "__main__":
    main()
