"""Ablation study: what each piece of Algorithm 1 buys.

Sweeps (ω, s, threshold_mode) at fixed τ and reports accuracy / overall
ratio / build time — quantifying the paper's claim that NORM-STRATIFIED
sampling (ω > 1) beats plain random sampling (ω = 1) on Gaussian-norm data.

    python -m repro_torch.examples.ablation

Counterpart of the reference's `examples/ablation.py`, on the CUDA card
(build times synchronized with it); `main(device="cpu", n=..., m=...,
d=...)` runs it on the CPU at another size.
"""
import time

import numpy as np
import torch

from repro_torch.core import metrics
from repro_torch.core.engine import ReverseKRanksEngine
from repro_torch.core.exact import exact_ranks, reverse_k_ranks
from repro_torch.core.types import RankTableConfig
from repro_torch.data.pipeline import synthetic_embeddings

CONFIGS = (
    (1, 640, "sampled"),        # plain random sampling, same budget
    (10, 64, "sampled"),        # the paper's stratified default
    (40, 16, "sampled"),        # over-stratified
    (10, 64, "norm_bound"),     # footnote-1 O(1) threshold range
    (10, 16, "sampled"),        # 4× smaller budget
)


def main(*, device=None, n: int = 12_000, m: int = 5_000, d: int = 200,
         k: int = 10, c: float = 2.0, n_eval: int = 10) -> list:
    users, items = synthetic_embeddings(0, n, m, d, norm_spread=0.45,
                                        device=device)
    rows = []
    print(f"{'config':38s} {'acc':>6s} {'ratio':>7s} {'build_s':>8s}")
    for omega, s, mode in CONFIGS:
        cfg = RankTableConfig(tau=500, omega=omega, s=s, threshold_mode=mode)
        t0 = time.time()
        eng = ReverseKRanksEngine.build(users, items, cfg, 1,
                                        device=users.device)
        if users.is_cuda:
            torch.cuda.synchronize(users.device)
        build = time.time() - t0
        accs, ratios = [], []
        for qi in range(n_eval):
            q = items[qi * 97 % m]
            truth = exact_ranks(users, items, q).cpu().numpy()
            ex_idx = reverse_k_ranks(users, items, q, k)[0].cpu().numpy()
            got = eng.query(q, k=k, c=c).indices.cpu().numpy()
            accs.append(metrics.accuracy(got, ex_idx, truth, c))
            ratios.append(metrics.overall_ratio(got, ex_idx, truth))
        name = f"omega={omega},s={s},mode={mode}"
        print(f"{name:38s} {np.mean(accs):6.3f} {np.mean(ratios):7.3f} "
              f"{build:8.2f}")
        rows.append((name, float(np.mean(accs)), float(np.mean(ratios))))
    return rows


if __name__ == "__main__":
    main()
