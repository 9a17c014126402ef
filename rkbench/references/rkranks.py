"""Plain reference of a c-approximate reverse k-ranks query (paper §4).

Plain PyTorch, independent of the code under test: it imports nothing of
`repro_torch` (nor `jax` or `repro`) and takes nothing the program made.
From the benchmark's own users, items and Algorithm 1 sample it builds
the rank table again (sort P by norm, thresholds from the sampled score
range, Eq. (1) by sort and weighted suffix sum, in blocks of users),
packs it at the configuration's storage, and answers a (B, d) block of
queries: step 1 (scores, the table lookup and the estimate), then steps
2-3 (R↓_k, R↑_k, the Lemma-1 classes, the k smallest composite keys,
ties to the lower user index).

Its arithmetic is the semantics of the port as of commit 0ea130a: the
f32 lookup and estimate of `src/repro_torch/core/query.py`
(`lookup_bounds_batch`, `_est_from_grid`, `select_topk`), and the int8
storage tier's certified lookup (`int8_indices`, `int8_bounds`,
`StorageSpec.pack_table` / `pack_users` of `core/types.py`), written out
again with the code range `qmax` as a parameter (127 for int8).

`compare` is the comparison that decides `correct`: the program's answers
to a sample of the window's batches against this reference.

`variant` puts a lower precision in place, for the control that the
comparison has to fail: "tf32" rounds every product operand to TF32's
10-bit mantissa (round to nearest even) before an f32 product, which is
what a TF32 matmul does to its inputs; "int4" stores at codes in [-7, 7]
where the configuration states int8.
"""
from __future__ import annotations

import numpy as np
import torch

EST_TOL = 1e-3              # relative tolerance on an estimated rank
RANGE_PAD = 0.05            # fractional widening of the sampled range
EPS_SPAN = 1e-12            # floor of a threshold span
I8_TRANSFORM_PAD = 1e-4     # extra widening of int comparisons, in steps
QMAX = {"int8": 127.0, "int4": 7.0}
BLOCK = 1 << 16             # users per block of the build


def f32(x: float) -> float:
    """A Python double rounded once to f32."""
    return float(torch.tensor(x, dtype=torch.float32))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to 10 mantissa bits, to nearest even."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & -0x2000
    return b.view(torch.float32)


def _affine(x: torch.Tensor, qmax: float):
    """Per-row affine codes in [-qmax, qmax]: x ≈ code·scale + off."""
    lo = x.amin(dim=1, keepdim=True)
    hi = x.amax(dim=1, keepdim=True)
    off = 0.5 * (lo + hi)
    scale = torch.clamp(hi - lo, min=EPS_SPAN) / torch.tensor(
        2.0 * qmax, dtype=torch.float32, device=x.device)
    codes = torch.clamp(torch.round((x - off) / scale), -qmax, qmax)
    return codes, scale, off


def _est(uq, idx, t_up, t_lo, edge_lo, edge_hi, r_lo, r_up, tau, top):
    """The §4.3 estimate: interpolation between the bracketing
    thresholds, margin decay outside the grid, clipped to [r_lo, r_up],
    minus the sub-unit tie-break above the grid."""
    span = torch.clamp(t_lo - t_up, min=EPS_SPAN)
    frac = torch.clamp((uq - t_up) / span, 0.0, 1.0)
    interior = (idx > 0) & (idx < tau)
    est_in = r_up + (r_lo - r_up) * frac
    rng = torch.clamp(edge_hi - edge_lo, min=EPS_SPAN)
    m_above = torch.clamp(uq - edge_hi, min=0.0) / rng
    m_below = torch.clamp(edge_lo - uq, min=0.0) / rng
    est_above = 1.0 + (r_up - 1.0) / (1.0 + tau * m_above)
    est_below = top - (top - r_lo) * torch.exp(-tau * m_below)
    est = torch.where(interior, est_in,
                      torch.where(idx == tau, est_above, est_below))
    est = torch.minimum(torch.maximum(est, r_lo), r_up)
    return est - 0.5 * m_above / (1.0 + m_above)


class Reference:
    """The reference engine over one configuration's inputs."""

    def __init__(self, users: torch.Tensor, items: torch.Tensor,
                 positions: torch.Tensor, weights: torch.Tensor, cfg: dict,
                 variant: str = "exact"):
        if variant not in ("exact", "tf32", "int4"):
            raise ValueError(f"unknown variant {variant!r}")
        storage = cfg["storage"]
        if storage not in ("f32", "int8"):
            raise ValueError(f"unknown storage {storage!r}")
        self.tau = int(cfg["tau"])
        self.n, self.m = int(users.shape[0]), int(items.shape[0])
        self.rnd = tf32_round if variant == "tf32" else (lambda x: x)
        self.qmax = (QMAX["int4"] if variant == "int4"
                     else QMAX.get(storage))
        users = users.to(torch.float32)
        norms = torch.linalg.norm(items.to(torch.float32), dim=1)
        order = torch.argsort(-norms, stable=True)
        samples = self.rnd(items[order[positions]].to(torch.float32))
        weights = weights.to(torch.float32)
        thr = torch.empty((users.shape[0], self.tau), dtype=torch.float32,
                          device=users.device)
        tab = torch.empty_like(thr)
        frac = torch.arange(self.tau, dtype=torch.float32,
                            device=users.device) / (self.tau - 1)
        for b0 in range(0, users.shape[0], BLOCK):
            s = self.rnd(users[b0:b0 + BLOCK]) @ samples.T      # (b, S)
            smin, smax = s.min(dim=1).values, s.max(dim=1).values
            pad = RANGE_PAD * torch.clamp(smax - smin, min=1e-6)
            lo, hi = smin - pad, smax + pad
            t = lo[:, None] + frac[None, :] * (hi - lo)[:, None]
            s_sorted, o = torch.sort(s, dim=1, stable=True)
            w = weights[o]
            suffix = torch.cat([torch.flip(torch.cumsum(
                torch.flip(w, [1]), dim=1), [1]), torch.zeros_like(w[:, :1])],
                dim=1)
            # #{s <= t}: the samples from there on are > t, Eq. (1)'s I[·]
            idx = torch.searchsorted(s_sorted, t.contiguous(), right=True)
            thr[b0:b0 + BLOCK] = t
            tab[b0:b0 + BLOCK] = 1.0 + torch.gather(suffix, 1, idx)
            del s, s_sorted, o, w, suffix, idx
        if self.qmax is None:
            self.users, self.thr, self.tab = self.rnd(users), thr, tab
            return
        q = self.qmax
        uscale = torch.clamp(users.abs().amax(dim=1, keepdim=True),
                             min=EPS_SPAN) / torch.tensor(
            q, dtype=torch.float32, device=users.device)
        self.rows = torch.clamp(torch.round(users / uscale), -q, q)
        self.uscale, self.uslack = uscale, 0.5 * uscale
        # the lookup reads the thresholds' scale and offset, not their codes
        _, self.thr_sc, self.thr_off = _affine(thr, q)
        grid = (-q + torch.arange(self.tau, dtype=torch.float64,
                                  device=thr.device) * (2.0 * q / (
                                      self.tau - 1))).to(torch.float32)
        self.thr_dev = ((thr - self.thr_off) / self.thr_sc
                        - grid[None, :]).abs().amax(dim=1, keepdim=True)
        del thr
        self.tab_q, self.tab_sc, self.tab_off = _affine(tab, q)
        del tab

    # ------------------------------------------------------------ step 1
    def _scores(self, qs: torch.Tensor):
        """(n, B) scores and their slack (None at f32)."""
        qs = qs.to(torch.float32)
        if self.qmax is None:
            return self.users @ self.rnd(qs).T, None
        scores = (self.rows @ qs.T) * self.uscale
        return scores, self.uslack * qs.abs().sum(dim=1)[None, :]

    def _quant_indices(self, uq, slack):
        q, tau = self.qmax, self.tau
        delta = torch.tensor(f32(2.0 * q / (tau - 1)), device=uq.device)
        s_n = (uq - self.thr_off) / self.thr_sc
        d_n = slack / self.thr_sc
        dev = self.thr_dev + f32(20.0 * I8_TRANSFORM_PAD)

        def count(v):
            return torch.clamp(torch.floor((v + q) / delta), -1.0,
                               float(tau)).to(torch.int64) + 1

        idx_hi = torch.clamp(count(s_n + d_n + dev), 0, tau)
        idx_lo = torch.clamp(count(s_n - d_n - dev), 0, tau)
        return idx_lo, idx_hi

    def lookup_indices(self, qs: torch.Tensor):
        """(idx_lo, idx_hi), each (n, B): the table columns a lookup
        brackets (the same at f32)."""
        uq, slack = self._scores(qs)
        if self.qmax is None:
            idx = torch.searchsorted(self.thr, uq.contiguous(), right=True)
            return idx, idx
        return self._quant_indices(uq, slack)

    def bounds(self, qs: torch.Tensor):
        """(r_lo, r_up, est), each (B, n)."""
        tau, top = self.tau, float(self.m + 1)
        uq, slack = self._scores(qs)
        clip = lambda i: torch.clamp(i, 0, tau - 1)
        if self.qmax is None:
            idx = torch.searchsorted(self.thr, uq.contiguous(), right=True)
            up, lo = clip(idx - 1), clip(idx)
            r_up = torch.where(idx == 0, top, torch.gather(self.tab, 1, up))
            r_lo = torch.where(idx == tau, 1.0,
                               torch.gather(self.tab, 1, lo))
            est = _est(uq, idx, torch.gather(self.thr, 1, up),
                       torch.gather(self.thr, 1, lo), self.thr[:, :1],
                       self.thr[:, tau - 1:], r_lo, r_up, tau, top)
            return r_lo.T, r_up.T, est.T
        q = self.qmax
        idx_lo, idx_hi = self._quant_indices(uq, slack)
        widen = f32(0.5 + I8_TRANSFORM_PAD) * self.tab_sc

        def deq(col):
            return torch.gather(self.tab_q, 1, col) * self.tab_sc \
                + self.tab_off

        r_up = torch.where(idx_lo == 0, top, deq(clip(idx_lo - 1)) + widen)
        r_lo = torch.where(idx_hi == tau, 1.0, deq(clip(idx_hi)) - widen)
        delta = f32(2.0 * q / (tau - 1))
        grid = lambda col: (col.to(torch.float32) * delta - q) \
            * self.thr_sc + self.thr_off
        est = _est(uq, idx_hi, grid(clip(idx_hi - 1)), grid(clip(idx_hi)),
                   -q * self.thr_sc + self.thr_off,
                   q * self.thr_sc + self.thr_off, r_lo, r_up, tau, top)
        return r_lo.T, r_up.T, est.T

    # --------------------------------------------------------- steps 2-3
    def keys(self, qs: torch.Tensor, c: float, k: int):
        """(key, est), each (B, n). The composite selection key, smaller
        is better: est for a guaranteed query, else class·(m + 2) + est
        with class 0 for Lemma 1 (1) (r↑ ≤ c·R↓_k), 2 for Lemma 1 (2)
        (r↓ > R↑_k), 1 else."""
        r_lo, r_up, est = self.bounds(qs)
        R_lo = torch.topk(r_lo, k, dim=1, largest=False).values[:, k - 1:]
        R_up = torch.topk(r_up, k, dim=1, largest=False).values[:, k - 1:]
        guaranteed = c * R_lo >= R_up
        accepted = r_up <= c * R_lo
        pruned = r_lo > R_up
        cls = torch.where(accepted, 0.0, torch.where(pruned, 2.0, 1.0))
        return torch.where(guaranteed, est, cls * float(self.m + 2) + est), \
            est

    def query(self, qs: torch.Tensor, k: int, c: float):
        """(indices (B, k) int64, est (B, k) f32) of the k smallest keys,
        ties to the lower user index."""
        key, est = self.keys(qs, c, k)
        idx = torch.sort(key, dim=1, stable=True).indices[:, :k]
        return idx, torch.gather(est, 1, idx)


def compare(ref: Reference, state: dict, window: dict, batches: list[int],
            traffic: dict) -> dict:
    """The numbers compared over the answers of `batches` (indices into
    the window's), with the quantiles and counts behind them. Each is a
    share of the sampled answer slots (batch × query × rank) that the
    reference refutes; a returned id outside [0, n) counts against both.

      est_off_share   |est − est_ref| > EST_TOL·max(1, |est_ref|), est
                      the program's estimated rank of the user it
                      returned and est_ref the reference's for that
                      user: the table (K2 and the pack) and step 1.
      pick_off_share  the reference's key of the returned user lies above
                      its k-th smallest key by more than EST_TOL·max(1,
                      est_k) + one f32 step of the k-th key, est_k the
                      k-th user's estimate: the selection (steps 2-3). The
                      tolerance is on the estimate alone, so a user of a
                      worse Lemma-1 class (m + 2 apart) or a worse
                      estimate within the k-th user's class both count;
                      the f32 step is the rounding of the composite key
                      class·(m + 2) + est, which the selection sorts in
                      f32. A user tied with the k-th key is no error:
                      many users share the estimate 1 exactly, and the
                      tie goes to the lower index, so a score's last bit
                      can swap which of them is returned."""
    k, c, qv = traffic["k"], traffic["c"], state["qv"]
    est_errs, gaps, hits = [], [], []
    for b in batches:
        qs = qv[b % qv.shape[0]]
        key, est = ref.keys(qs, c, k)
        order = torch.sort(key, dim=1, stable=True)
        key_k = order.values[:, k - 1:k]
        est_k = torch.gather(est, 1, order.indices[:, k - 1:k])
        tol = EST_TOL * torch.clamp(est_k.abs(), min=1.0) \
            + (torch.nextafter(key_k, torch.full_like(key_k, torch.inf))
               - key_k)
        idx, got = (x.to(qs.device) for x in window["answers"][b])
        valid = (idx >= 0) & (idx < ref.n)
        idx = torch.where(valid, idx, 0)
        want = torch.gather(est, 1, idx)
        err = (got - want).abs() / torch.clamp(want.abs(), min=1.0)
        gap = (torch.gather(key, 1, idx) - key_k) / tol
        bad = ~valid | torch.isnan(err) | torch.isnan(gap)
        est_errs.append(torch.where(bad, torch.inf, err).flatten().cpu())
        gaps.append(torch.where(bad, torch.inf, gap).flatten().cpu())
        hits.append(((idx[:, :, None] == order.indices[:, None, :k])
                     .any(-1) & valid).flatten().cpu())
    err = torch.cat(est_errs).double().numpy()
    gap = torch.cat(gaps).double().numpy()
    hit = torch.cat(hits).numpy()
    q = [0.5, 0.9, 0.99, 0.999, 1.0]
    return {"est_off_share": float(np.mean(err > EST_TOL)),
            "pick_off_share": float(np.mean(gap > 1.0)),
            "slots": int(err.size), "queries": int(err.size // k),
            "est_err_q": [float(x) for x in np.quantile(err, q)],
            "pick_gap_q": [float(x) for x in np.quantile(gap, q)],
            "est_off": int(np.sum(err > EST_TOL)),
            "pick_off": int(np.sum(gap > 1.0)),
            "not_in_ref_topk": int(np.sum(~hit))}
