"""Item-centric retrieval serving: the full paper pipeline — ratings →
matrix factorization → rank-table index → ONLINE c-approximate reverse
k-ranks serving → §5 metrics, plus backbone-encoded embeddings to show
the engine composes with the assigned architectures.

    python -m repro_torch.examples.serve_retrieval

Counterpart of the reference's `examples/serve_retrieval.py`, on the CUDA
card; `main(device="cpu", n_users=..., n_items=..., n_ratings=...)` runs
it on the CPU at another size. Step 4 encodes token sequences with
gemma-2b (`backbone_embeddings`: the embedding and the layer stack,
mean-pooled, as f32) and indexes them (`backbone_step`): at the published
width on the card, at `reduced()` widths on the CPU.

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

from repro_torch.configs import get_config, reduced
from repro_torch.core import metrics
from repro_torch.core.engine import ReverseKRanksEngine
from repro_torch.core.exact import exact_ranks, reverse_k_ranks
from repro_torch.core.types import RankTableConfig
from repro_torch.data.mf import MFConfig, embeddings, train_mf
from repro_torch.data.pipeline import synthetic_ratings
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.serve import MicroBatcher

# step 4: the reference's backbone, index and query
BACKBONE = "gemma-2b"
BACKBONE_TABLE = RankTableConfig(tau=64, omega=4, s=16)
SEQ_USERS, SEQ_ITEMS, SEQ_LEN = 256, 128, 16
SEQ_K, SEQ_C, SEQ_ITEM = 5, 2.0, 7


def backbone_config(dev: torch.device) -> ModelConfig:
    """gemma-2b at its published size on the card, `reduced` on the CPU."""
    cfg = get_config(BACKBONE)
    return cfg if dev.type == "cuda" else reduced(cfg)


def backbone_embeddings(params: dict, cfg: ModelConfig,
                        tokens: torch.Tensor, *,
                        batch: int = 512) -> torch.Tensor:
    """(N, S) token sequences → (N, d_model) f32 embeddings: the token
    embedding and every layer (no final norm), mean-pooled over the
    sequence in cfg.dtype, encoded `batch` sequences at a time."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    out = []
    with torch.no_grad():
        for i in range(0, tokens.shape[0], batch):
            x = T._embed(params, tokens[i:i + batch], cfg)
            x = T._apply_segments(params["segments"], cfg.segments(), x,
                                  cfg, positions)
            out.append(x.mean(dim=1).float())
    return torch.cat(out)


def backbone_step(dev: torch.device, *, cfg: ModelConfig = None,
                  params: dict = None, tok_u: torch.Tensor = None,
                  tok_i: torch.Tensor = None, n_users: int = SEQ_USERS,
                  n_items: int = SEQ_ITEMS, batch: int = 512,
                  positions=None, weights=None) -> dict:
    """Step 4: random user and item token sequences of SEQ_LEN tokens
    (seeds 4, 5) through the backbone (parameters from seed 3 unless
    given), a rank table over the embeddings (samples from seed 6 unless
    `positions` / `weights` are given) on the fused backend (K2 builds
    it, K1 answers on the card; the reference's dense backend gives the
    same answer), and the reverse SEQ_K-ranks of item SEQ_ITEM. Returns
    the embeddings, the engine, the result and the encode and build
    seconds."""
    cfg = cfg or backbone_config(dev)
    if params is None:
        params = T.init_params(3, cfg, dev)
    draws = []
    for seed, n, given in ((4, n_users, tok_u), (5, n_items, tok_i)):
        if given is None:
            g = torch.Generator(device=dev)
            g.manual_seed(seed)
            given = torch.randint(cfg.vocab, (n, SEQ_LEN), generator=g,
                                  device=dev)
        draws.append(given.to(dev))
    t0 = time.perf_counter()
    u_emb = backbone_embeddings(params, cfg, draws[0], batch=batch)
    i_emb = backbone_embeddings(params, cfg, draws[1], batch=batch)
    _sync(dev)
    t1 = time.perf_counter()
    eng = ReverseKRanksEngine.build(u_emb, i_emb, BACKBONE_TABLE, 6,
                                    backend="fused", device=dev,
                                    positions=positions, weights=weights)
    _sync(dev)
    t2 = time.perf_counter()
    res = eng.query(i_emb[SEQ_ITEM], k=SEQ_K, c=SEQ_C)
    print(f"backbone-embedded reverse {SEQ_K}-ranks for item {SEQ_ITEM} → "
          f"users {res.indices.tolist()} (engine composes with any arch)")
    return {"users": u_emb, "items": i_emb, "engine": eng, "result": res,
            "encode_s": t1 - t0, "build_s": t2 - t1}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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
    _sync(dev)                          # before the MicroBatcher starts
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

    # --- 4. backbone-encoded embeddings (engine ∘ assigned architecture) --
    backbone_step(dev)
    return {"losses": losses, "accuracy": float(np.mean(accs)),
            "overall_ratio": float(np.mean(ratios))}


if __name__ == "__main__":
    main()
