#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

  1. device line: the card's name and power limit, torch and CUDA;
  2. build K1-K5 from `src/repro_torch/kernels/csrc/*.cu` with nvcc;
  3. each kernel against its plain PyTorch version on the card at ragged
     shapes (K4/K5 on integer inputs, where they must agree exactly, with
     stored and with raw f32 users; and on randn inputs, where query 0
     must come out bitwise the same at every query count given the same
     ‖q‖₁), and the port's engine on the card against the same engine on
     the CPU at a small size, at each spec;
  4. the main path at the paper's Netflix size (n = 480,189 users,
     m = 17,770 items, d = 200; tau = 500, omega = 10, s = 64), on
     synthetic embeddings from a seed: Algorithm 1 build on the fused
     backend (K2), query_batch of 16 item queries and one query (K1),
     exact grading of those queries through K3 with the §5 accuracy and
     overall ratio, held against the dense backend. The launch counts are
     zeroed just before and read just after; each kernel must have run;
  4b. the storage tier on the same data: builds at bf16 and int8 with the
     f32 build's samples (K2), whose packs must equal `pack_table` /
     `pack_users` of the f32 arrays; query_batch and query on the fused
     backend (K4, K5) and on dense; certified containment of every
     (query, user) bound in the f32 engine's K1 bounds; the §5 metrics
     against the exact ranks of phase 4; memory_bytes. Its own launch
     counts, zeroed before and read after; K4 and K5 must have run;
  5. each kernel against its plain version on the main path's inputs,
     and their times beside the card's bound.

The explained-mismatch rule: a kernel and its plain version compute the
same f32 dot products in different orders, so a score may differ by the
f32 rounding bound eps = 2·d·2^-24·Σ_k |a_k·b_k|. Where a bucketize index
or a count differs, the plain score must lie within eps of the threshold
(K1, K2) or of u·q (K3). Everywhere else r_lo, r_up, the table and the
ranks are exact, and est agrees to 1e-5 relative plus its sensitivity to
a score error of eps.

K4 and K5 at Netflix size follow the bracketing rule: their scores come
from another summation order than the plain version's (eps as above, on
the dequantized rows), so where a bound differs, the kernel's r_lo/r_up
must lie between the plain version's at score - eps and score + eps; est
must lie between the plain version's at the two ends (1e-5 relative)
where neither index moves between them, and in [r_lo - 0.5, r_up]
elsewhere.

The last lines are a JSON object of per-kernel numbers, the nvidia-smi
name and power limit, and the result object.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N, M, D = 480_189, 17_770, 200     # Netflix (src/repro/configs/paper_engine.py)
TAU, OMEGA, S_PER = 500, 10, 64    # DEFAULT_TABLE
K, C, B = 10, 2.0, 16
QUERY_ITEM = 42                    # the item examples/quickstart.py queries
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12            # H100 SXM, f32 outside the tensor cores
U24 = 2.0 ** -24


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over reps calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------- parity
def score_eps(torch, a, b):
    """Per-pair f32 rounding bound of two dot-product orders, (na, nb)."""
    d = a.shape[1]
    return 2.0 * d * U24 * (a.abs() @ b.abs().T)


def check_k1(torch, ops, ref, users, qs, thr, tab, m, label):
    """K1 against its plain version under the explained-mismatch rule."""
    got = [x.T for x in ops.bound_ranks_batched(users, qs, thr, tab, m=m)]
    want = ref.ref_bound_ranks(users, qs, thr, tab, m)         # (n, B)
    torch.cuda.synchronize()
    tau = thr.shape[1]
    scores = users @ qs.T
    eps = score_eps(torch, users, qs)
    idx = torch.searchsorted(thr, scores.contiguous(), right=True)
    up_col = (idx - 1).clamp(0, tau - 1)
    lo_col = idx.clamp(0, tau - 1)
    bounds_differ = (got[0] != want[0]) | (got[1] != want[1])
    near = torch.minimum((scores - torch.gather(thr, 1, up_col)).abs(),
                         (scores - torch.gather(thr, 1, lo_col)).abs())
    unexplained = bounds_differ & ~(near <= eps)
    check(not bool(unexplained.any()),
          f"K1 {label}: {int(unexplained.sum())} bound mismatches not "
          "explained by a score within eps of a threshold")
    # est: 1e-5 relative plus |d est / d score|·eps on cells whose bounds agree
    r_lo, r_up = want[0], want[1]
    span = (torch.gather(thr, 1, lo_col)
            - torch.gather(thr, 1, up_col)).clamp(min=1e-12)
    rng = (thr[:, -1:] - thr[:, :1]).clamp(min=1e-12)
    interior = (idx > 0) & (idx < tau)
    sens = torch.where(interior, (r_up - r_lo) / span,
                       torch.where(idx == tau,
                                   (r_up - 1.0) * tau / rng + 0.5 / rng,
                                   (m + 1 - r_lo) * tau / rng))
    est_err = (got[2] - want[2]).abs()
    allowed = 1e-5 * want[2].abs() + sens * eps
    bad_est = ~bounds_differ & (est_err > allowed)
    if bool(bad_est.any()):
        raise SmokeFailure(
            f"K1 {label}: {int(bad_est.sum())} est cells beyond tolerance "
            f"(max err {float(est_err[bad_est].max()):.3g})")
    for x in got:
        check(bool(torch.isfinite(x).all()), f"K1 {label}: non-finite output")
    max_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    same = ~bounds_differ
    est_same = float(est_err[same].max()) if bool(same.any()) else 0.0
    print(f"  K1 {label}: n={users.shape[0]} d={users.shape[1]} "
          f"tau={tau} B={qs.shape[0]}: {int(bounds_differ.sum())} of "
          f"{bounds_differ.numel()} cells with a bucketize flip, all "
          f"explained; est max err where bounds agree {est_same:.3g}; "
          f"max abs err over all cells {max_err:.3g}")
    return max_err


def check_k2(torch, ops, ref, users, samples, weights, thr, label):
    """K2 against its plain version under the explained-mismatch rule."""
    got = ops.build_table_rows(users, samples, weights, thr)
    want = ref.ref_table_rows(users, samples, weights, thr)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    loose = diff > 1e-5 * want.abs()
    rows = torch.nonzero(loose.any(dim=1)).flatten()
    n_unexplained = 0
    for start in range(0, rows.numel(), 256):
        r = rows[start:start + 256]
        sc = users[r] @ samples.T                               # (b, S)
        eps = score_eps(torch, users[r], samples)
        # weight of samples within eps of each threshold: (b, τ)
        near = ((sc[:, :, None] - thr[r][:, None, :]).abs()
                <= eps[:, :, None]).to(torch.float32)
        mass = torch.einsum("bst,s->bt", near, weights)
        bad = loose[r] & (diff[r] > mass + 1e-5 * want[r].abs())
        n_unexplained += int(bad.sum())
    check(n_unexplained == 0,
          f"K2 {label}: {n_unexplained} table cells differ by more than "
          "the weight of the samples within eps of the threshold")
    check(bool(torch.isfinite(got).all()), f"K2 {label}: non-finite output")
    max_err = float(diff.max())
    print(f"  K2 {label}: n={users.shape[0]} d={users.shape[1]} "
          f"S={samples.shape[0]} tau={thr.shape[1]}: {int(loose.sum())} of "
          f"{loose.numel()} cells differ, all explained; max abs err "
          f"{max_err:.3g}")
    return got, max_err


def check_k3(torch, ops, ref, users, items, q, label, got=None):
    """K3 (or its result `got`) against the plain version."""
    if got is None:
        got = ops.exact_ranks(users, items, q)
    want = 1 + ref.ref_exact_counts(users, items, q)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    rows = torch.nonzero(diff > 0).flatten()
    n_unexplained = 0
    for start in range(0, rows.numel(), 1024):
        r = rows[start:start + 1024]
        u = users[r]
        up = u @ items.T
        uq = u @ q
        eps = score_eps(torch, u, items) + (2.0 * u.shape[1] * U24
                                            * (u.abs() @ q.abs()))[:, None]
        n_near = ((up - uq[:, None]).abs() <= eps).sum(dim=1)
        n_unexplained += int((diff[r] > n_near).sum())
    check(n_unexplained == 0,
          f"K3 {label}: {n_unexplained} ranks differ by more than the "
          "number of items within eps of u·q")
    check(bool((got >= 1).all()) and bool((got <= items.shape[0] + 1).all()),
          f"K3 {label}: rank out of [1, m+1]")
    max_err = float(diff.max()) if diff.numel() else 0.0
    return got, int(rows.numel()), max_err


def selections_agree(torch, query_mod, fused, dense, f_bounds, d_bounds,
                     k, c, m):
    """Fused and dense selections agree modulo ties: a user in one set
    and not the other either has bounds that differ between the two
    backends (a bucketize flip, explained by the K1 check) or a dense
    key within 2·tol of the dense k-th key, where tol is the largest est
    difference of users whose bounds agree. Returns (users selected by
    one backend only, tol)."""
    flips = (f_bounds[0] != d_bounds[0]) | (f_bounds[1] != d_bounds[1])
    tol = float((f_bounds[2] - d_bounds[2])[~flips].abs().max())
    key = query_mod.lemma1_key(*d_bounds, R_lo_k=dense.R_lo_k,
                               R_up_k=dense.R_up_k, c=c, m_items=m)[0]
    kth = torch.sort(key, dim=-1).values[:, k - 1]
    n_diff = 0
    for b in range(key.shape[0]):
        stats_same = (bool(fused.R_lo_k[b] == dense.R_lo_k[b])
                      and bool(fused.R_up_k[b] == dense.R_up_k[b]))
        if not stats_same:
            check(bool(flips[b].any()),
                  f"query {b}: order statistics differ without a flip")
        for u in set(fused.indices[b].tolist()) ^ set(
                dense.indices[b].tolist()):
            n_diff += 1
            if bool(flips[b, u]) or not stats_same:
                continue
            limit = float(kth[b]) + 2 * tol + 1e-6 * abs(float(kth[b]))
            check(float(key[b, u]) <= limit,
                  f"query {b}: user {u} selected by one backend only, "
                  "not a tie")
    return n_diff, tol


def check_quant_exact(torch, ops, ref, Q, users, qs, rt, label):
    """K4/K5 against the plain version on integer inputs: exact scores
    and slacks, so r_lo/r_up agree bitwise and est to 1e-5 relative."""
    rows, uscale, uslack = ops.stored_parts(users, rt.spec_kind)
    got = [x.T for x in ops.bound_ranks_batched_stored(users, qs, rt)]
    want = ref.ref_bound_ranks_stored(rows, uscale, uslack, qs,
                                      Q.query_l1(qs), rt)
    torch.cuda.synchronize()
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"{label}: bounds differ from the plain version on integer "
          "inputs")
    err = (got[2] - want[2]).abs()
    check(bool((err <= 1e-5 * want[2].abs()).all()),
          f"{label}: est beyond 1e-5 relative (max err {float(err.max())})")
    return got


def quant_launches(torch, ops, users, qs, qn, rt):
    """K4/K5 launched directly, ≤ 16 queries a launch as the wrapper
    does, with the caller's ‖q‖₁ `qn` → (r_lo, r_up, est), each (n, B)."""
    rows, uscale, uslack = ops.stored_parts(users, rt.spec_kind)
    n, B = rows.shape[0], qs.shape[0]
    out = torch.empty((3, n, B), dtype=torch.float32, device=rows.device)
    step = ops.user_scores.MAX_B
    for b0 in range(0, B, step):
        b1 = min(B, b0 + step)
        ops.user_scores.bound_ranks_quant_kernel_call(
            rt.spec_kind, rows, uscale, uslack, qs[b0:b1].contiguous(),
            qn[b0:b1].contiguous(), rt, out[0, :, b0:b1], out[1, :, b0:b1],
            out[2, :, b0:b1])
    torch.cuda.synchronize()
    return out[0], out[1], out[2]


def search_bytes(row_bytes: int, nb: int) -> int:
    """Least bytes a search of one user's sorted row reads for nb
    queries: a binary search over the row's 32-byte sectors touches
    ⌈log2(sectors)⌉ + 1 of them per query (a query's two keys share
    theirs), and no more than the whole row."""
    return min(row_bytes, nb * (math.ceil(math.log2(row_bytes / 32)) + 1)
               * 32)


def gather_bytes(torch, idx_hi, tau: int, elem: int, idx_lo=None) -> int:
    """Bytes of the distinct 32-byte sectors of an (n, tau) table of
    `elem`-byte values that the lookups at (n, B) bucketize indices read:
    T[idx_lo - 1] where idx_lo > 0 and T[idx_hi] where idx_hi < tau
    (idx_lo defaults to idx_hi, as in the f32 lookup)."""
    idx_lo = idx_hi if idx_lo is None else idx_lo
    base = torch.arange(idx_hi.shape[0], device=idx_hi.device)[:, None] * tau
    cells = torch.cat([(base + idx_lo - 1)[idx_lo > 0],
                       (base + idx_hi)[idx_hi < tau]])
    return 32 * int(torch.unique(cells * elem // 32).numel())


def check_quant(torch, ops, ref, Q, users, qs, rt, label):
    """K4/K5 against the plain version under the bracketing rule (module
    docstring). Returns (max abs err over all cells, cells that differ)."""
    rows, uscale, uslack = ops.stored_parts(users, rt.spec_kind)
    got = [x.T for x in ops.bound_ranks_batched_stored(users, qs, rt)]
    qn = Q.query_l1(qs)
    want = ref.ref_bound_ranks_stored(rows, uscale, uslack, qs, qn, rt)
    torch.cuda.synchronize()
    tau = rt.tau
    deq = rows.to(torch.float32)
    if uscale is not None:
        deq = deq * uscale
    eps = 2.0 * (rows.shape[1] + 1) * U24 * (deq.abs() @ qs.abs().T)
    del deq
    scores = Q._dequant_matmul(rows, uscale, qs)
    slack = uslack * qn[None, :]
    indices, bounds = {"bf16": (Q.bf16_indices, Q.bf16_bounds),
                       "int8": (Q.int8_indices, Q.int8_bounds)}[rt.spec_kind]
    ends = []
    for sgn in (-1.0, 1.0):
        uq = scores + sgn * eps
        idx = indices(rt, uq, slack)
        ends.append((idx, bounds(rt, *idx),
                     Q.lookup_bounds_batch(rt, uq, slack)[2]))
    (ia, (lo_a, up_a), e_a), (ib, (lo_b, up_b), e_b) = ends
    inf = torch.full_like(lo_a, float("inf"))
    # r_lo over idx_hi in [ia_hi, ib_hi] and r_up over idx_lo in
    # [ia_lo, ib_lo]: the table part is monotone, and the out-of-grid
    # values (1 at idx_hi = tau, m+1 at idx_lo = 0) are the two ends,
    # so the extremes are the ends and the last (first) table column
    lo_c = bounds(rt, ia[0], ib[1].clamp(max=tau - 1))[0]
    up_c = bounds(rt, ia[0].clamp(min=1), ib[1])[1]
    has_c = ia[1] < tau
    has_d = ib[0] >= 1
    lo_min = torch.minimum(torch.minimum(lo_a, lo_b),
                           torch.where(has_c, lo_c, inf))
    lo_max = torch.maximum(torch.maximum(lo_a, lo_b),
                           torch.where(has_c, lo_c, -inf))
    up_min = torch.minimum(torch.minimum(up_a, up_b),
                           torch.where(has_d, up_c, inf))
    up_max = torch.maximum(torch.maximum(up_a, up_b),
                           torch.where(has_d, up_c, -inf))
    differ = (got[0] != want[0]) | (got[1] != want[1])
    outside = ((got[0] < lo_min) | (got[0] > lo_max)
               | (got[1] < up_min) | (got[1] > up_max))
    check(not bool((differ & outside).any()),
          f"{label}: {int((differ & outside).sum())} bound mismatches "
          "outside the plain version's bounds at score -/+ eps")
    stable = (ia[0] == ib[0]) & (ia[1] == ib[1])
    tol = 1e-5 * torch.maximum(e_a.abs(), e_b.abs())
    e_bad = stable & ((got[2] < torch.minimum(e_a, e_b) - tol)
                      | (got[2] > torch.maximum(e_a, e_b) + tol))
    e_bad |= ~stable & ((got[2] < got[0] - 0.5 - 1e-4)
                        | (got[2] > got[1] + 1e-4))
    check(not bool(e_bad.any()),
          f"{label}: {int(e_bad.sum())} est cells outside the rule")
    for x in got:
        check(bool(torch.isfinite(x).all()), f"{label}: non-finite output")
    max_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    print(f"  {label}: n={rows.shape[0]} d={rows.shape[1]} tau={tau} "
          f"B={qs.shape[0]}: {int(differ.sum())} of {differ.numel()} cells "
          f"with a bound that differs, all bracketed; {int((~stable).sum())}"
          f" cells with an index within eps of a step; max abs err "
          f"{max_err:.3g}")
    return max_err, int(differ.sum())


def check_containment(torch, res, want, label):
    """Certified containment of a spec's bounds in the f32 bounds on
    every (query, user), and of its order statistics, to 1e-4."""
    over_lo = res.r_lo - want.r_lo            # must be <= 1e-4
    under_up = want.r_up - res.r_up           # must be <= 1e-4
    n_bad = int((over_lo > 1e-4).sum()) + int((under_up > 1e-4).sum())
    stats_ok = (bool((res.R_lo_k <= want.R_lo_k + 1e-4).all())
                and bool((res.R_up_k >= want.R_up_k - 1e-4).all()))
    margin = max(float(over_lo.max()), float(under_up.max()))
    print(f"  containment {label}: {n_bad} violations in "
          f"{over_lo.numel()} cells; largest r_lo - r_lo(f32) or "
          f"r_up(f32) - r_up {margin:.3g}; mean widening of r_lo "
          f"{float(-over_lo.mean()):.3g} and of r_up "
          f"{float(-under_up.mean()):.3g} ranks; order statistics "
          f"bracketed: {stats_ok}")
    check(n_bad == 0 and stats_ok, f"containment {label} fails")


# ------------------------------------------------------------ main path
def main() -> int:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError as e:
        print(f"FAIL: torch is not importable: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    try:
        from repro_torch.core import exact as exact_mod
        from repro_torch.core import metrics
        from repro_torch.core import query as query_mod
        from repro_torch.core import rank_table as rt_mod
        from repro_torch.core.engine import ReverseKRanksEngine
        from repro_torch.core.types import RankTableConfig
        from repro_torch.data.pipeline import synthetic_embeddings
        from repro_torch.kernels import _build, ops, ref
    except ImportError as e:
        print(f"FAIL: the port is not importable here ({e}); run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    try:
        kernels = run(torch, exact_mod, metrics, query_mod, rt_mod,
                      ReverseKRanksEngine, RankTableConfig,
                      synthetic_embeddings, _build, ops, ref)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")]
    if leaked:
        print(f"FAIL: JAX or the reference was imported: {leaked}",
              file=sys.stderr)
        return 1
    print(f"total wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run(torch, exact_mod, metrics, query_mod, rt_mod, ReverseKRanksEngine,
        RankTableConfig, synthetic_embeddings, _build, ops, ref):
    dev = torch.device("cuda")
    # 1. device line
    print(f"device: {nvidia_smi_line()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
          f"matmul precision={torch.get_float32_matmul_precision()}")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")

    # 2. build
    t0 = time.perf_counter()
    info = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s wall for "
          f"{len(info)} sources in parallel")
    for name, rec in info.items():
        print(f"  {name}: {rec['seconds']:.1f} s -> {rec['path']}")
        for line in rec["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"    ptxas: {line.strip()}")

    # 3. kernels against plain versions at ragged shapes
    print("phase: kernels vs plain, ragged shapes")
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    for (n, m, d, tau, bs) in [(1000, 777, 37, 37, (1, 2, 3, 6, 16, 19)),
                               (333, 300, 200, 128, (1, 16)),
                               (300, 500, 24, 777, (1, 5, 16))]:
        users = torch.randn((n, d), generator=g, device=dev)
        items = torch.randn((m, d), generator=g, device=dev) * (
            1.0 + 0.3 * torch.randn((m, 1), generator=g, device=dev)).abs()
        cfg = RankTableConfig(tau=tau, omega=4, s=16)
        items_sorted, _ = rt_mod.sort_items_by_norm(items)
        pos, w = rt_mod.stratified_sample_indices(m, cfg, g)
        samples = items_sorted[pos].contiguous()
        rt = rt_mod.build_rank_table_sorted(users, items_sorted, cfg,
                                            positions=pos, weights=w)
        check_k2(torch, ops, ref, users, samples, w, rt.thresholds,
                 "ragged")
        w_rand = torch.rand((samples.shape[0],), generator=g,
                            device=dev) + 0.5
        check_k2(torch, ops, ref, users, samples, w_rand, rt.thresholds,
                 "ragged, random weights")
        first = None
        for nb in bs:
            qs = items[torch.arange(nb, device=dev) * 5 % m].contiguous()
            check_k1(torch, ops, ref, users, qs, rt.thresholds, rt.table,
                     m, "ragged")
            # K1 instantiates B = 1, 2, 4, 8, 16; query 0 must come out
            # bitwise the same from every instance
            got = [x[0] for x in ops.bound_ranks_batched(
                users, qs, rt.thresholds, rt.table, m=m)]
            first = got if first is None else first
            check(all(torch.equal(a, b) for a, b in zip(got, first)),
                  f"K1 ragged: query 0 at B={nb} differs from B={bs[0]}")
        for q, what in ((items[11], "q in P"),
                        (torch.randn((d,), generator=g, device=dev),
                         "random q")):
            _, n_diff, err = check_k3(torch, ops, ref, users, items,
                                      q.contiguous(), "ragged")
            print(f"  K3 ragged ({what}): n={n} m={m} d={d}: {n_diff} "
                  f"ranks differ, all explained; max abs err {err}")

    print("phase: K4/K5 vs plain, ragged shapes, integer inputs")
    Q = query_mod
    users = torch.randint(-4, 5, (1000, 37), generator=g, device=dev).float()
    items = torch.randint(-4, 5, (777, 37), generator=g, device=dev).float()
    for spec in ("bf16", "int8"):
        for tau in (37, 777):
            cfg = RankTableConfig(tau=tau, omega=4, s=16, storage_dtype=spec)
            rt = rt_mod.build_rank_table(users, items, cfg, g)
            su = cfg.storage.pack_users(users)
            check(rt.spec_kind == spec, f"{spec} build packed {rt.spec_kind}")
            for u, what in ((su, "stored"), (users, "raw f32")):
                first = None
                for nb in (1, 2, 3, 6, 16, 19):
                    qs = items[torch.arange(nb, device=dev) * 5 % 777]
                    got = check_quant_exact(
                        torch, ops, ref, Q, u, qs.contiguous(), rt,
                        f"{spec} tau={tau} {what} B={nb}")
                    # query 0 must come out bitwise the same at every B
                    got = [x[:, 0] for x in got]
                    first = got if first is None else first
                    check(all(torch.equal(a, b) for a, b in zip(got, first)),
                          f"{spec} ragged: query 0 at B={nb} differs from "
                          "B=1")
            print(f"  {spec} (K{4 if spec == 'bf16' else 5}): n=1000 d=37 "
                  f"tau={tau}, B in 1,2,3,6,16,19, stored and raw f32 "
                  "users: bounds exact, est within 1e-5, query 0 bitwise "
                  "the same at every B")

    # On integer inputs every summation order gives the same score, so the
    # check above cannot tell two instantiations of K4/K5 apart. Here the
    # users and queries are randn, and one ‖q‖₁ vector is shared by every
    # launch: query 0 must still come out bitwise the same at every B.
    print("phase: K4/K5 query 0 across B, randn inputs")
    users = torch.randn((1000, 37), generator=g, device=dev)
    items = torch.randn((777, 37), generator=g, device=dev)
    qs = torch.randn((19, 37), generator=g, device=dev)
    qn = Q.query_l1(qs)
    for spec in ("bf16", "int8"):
        for tau in (37, 777):
            cfg = RankTableConfig(tau=tau, omega=4, s=16, storage_dtype=spec)
            rt = rt_mod.build_rank_table(users, items, cfg, g)
            n_diffs = []
            for u, what in ((cfg.storage.pack_users(users), "stored"),
                            (users, "raw f32")):
                first = None
                for nb in (1, 2, 3, 6, 16, 19):
                    got = [x[:, 0] for x in quant_launches(
                        torch, ops, u, qs[:nb], qn[:nb], rt)]
                    first = got if first is None else first
                    check(all(torch.equal(a, b) for a, b in zip(got, first)),
                          f"{spec} tau={tau} {what}, randn: query 0 at "
                          f"B={nb} differs from B=1")
                n_diffs.append(check_quant(torch, ops, ref, Q, u, qs, rt,
                                           f"{spec} tau={tau} {what} "
                                           "randn")[1])
            print(f"  {spec}: tau={tau}, stored and raw f32 users: query 0 "
                  "bitwise the same at B in 1,2,3,6,16,19; B=19 within the "
                  f"bracketing rule ({n_diffs} cells differ from plain)")

    print("phase: engine on the card vs the same engine on the CPU")
    users, items = synthetic_embeddings(3, 2048, 1024, 32, device=dev)
    cfg = RankTableConfig(tau=64)
    pos, w = rt_mod.stratified_sample_indices(1024, cfg, g)
    qs = items[:8].contiguous()
    res, bounds = {}, {}
    for where in (dev, torch.device("cpu")):
        eng = ReverseKRanksEngine.build(
            users, items, cfg, None, backend="fused", device=where,
            positions=pos.to(where), weights=w.to(where))
        out = eng.query_batch(qs.to(where), K, C)
        res[where.type] = type(out)(*(x.to(dev) for x in out))
        rt = eng.rank_table
        bounds[where.type] = [x.to(dev) for x in ops.bound_ranks_batched(
            eng.users, qs.to(where), rt.thresholds, rt.table, m=rt.m)]
    n_diff, _ = selections_agree(torch, query_mod, res[dev.type], res["cpu"],
                                 bounds[dev.type], bounds["cpu"], K, C, 1024)
    print(f"  small engine (n=2048, m=1024, d=32, tau=64, B=8): {n_diff} "
          "users selected on one device only, all explained")
    for spec in ("bf16", "int8"):
        cfg = RankTableConfig(tau=64, storage_dtype=spec)
        res, bounds = {}, {}
        for where in (dev, torch.device("cpu")):
            eng = ReverseKRanksEngine.build(
                users, items, cfg, None, backend="fused", device=where,
                positions=pos.to(where), weights=w.to(where))
            out = eng.query_batch(qs.to(where), K, C)
            res[where.type] = type(out)(*(x.to(dev) for x in out))
            bounds[where.type] = [
                x.to(dev) for x in ops.bound_ranks_batched_stored(
                    eng.stored_users, qs.to(where), eng.rank_table)]
        n_diff, _ = selections_agree(torch, query_mod, res[dev.type],
                                     res["cpu"], bounds[dev.type],
                                     bounds["cpu"], K, C, 1024)
        print(f"  small engine at {spec}: {n_diff} users selected on one "
              "device only, all explained")

    # 4. main path at Netflix scale
    print(f"phase: main path, n={N} m={M} d={D} tau={TAU} omega={OMEGA} "
          f"s={S_PER}, B={B}, k={K}, c={C}")
    users, items = synthetic_embeddings(0, N, M, D, device=dev)
    cfg = RankTableConfig(tau=TAU, omega=OMEGA, s=S_PER)
    gb = torch.Generator(device=dev)
    gb.manual_seed(1)
    pos, w = rt_mod.stratified_sample_indices(M, cfg, gb)
    gq = torch.Generator(device=dev)
    gq.manual_seed(2)
    qids = torch.randperm(M, generator=gq, device=dev)[:B]
    qids[0] = QUERY_ITEM
    qs = items[qids].contiguous()
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng = ReverseKRanksEngine.build(users, items, cfg, None,
                                    backend="fused", device=dev,
                                    positions=pos, weights=w)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = eng.query_batch(qs, K, C)
    torch.cuda.synchronize()
    qb_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    res1 = eng.query(items[QUERY_ITEM], K, C)
    torch.cuda.synchronize()
    q1_ms = (time.perf_counter() - t0) * 1e3
    truth, exact_idx = [], []
    t0 = time.perf_counter()
    for b in range(B):
        idx, _ = exact_mod.reverse_k_ranks(users, items, qs[b], K)
        exact_idx.append(idx)
        truth.append(exact_mod.exact_ranks(users, items, qs[b]))
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    print(f"  launches on the main path: {counts}")
    for name in ("k1_bound_ranks", "k2_table_build", "k3_exact_ranks"):
        check(counts[name] >= 1,
              f"kernel {name} was not launched on the main path")
    mem = eng.memory_bytes()
    print(f"  build {build_s:.3f} s (host clock, incl. sort, sampling and "
          f"the K2 launch); query_batch(B={B}) {qb_ms:.2f} ms; query "
          f"{q1_ms:.2f} ms; exact grading {exact_s:.2f} s for {B} queries "
          f"({2 * B} K3 launches: ranks + reverse_k_ranks)")
    print(f"  memory_bytes {mem} ({mem / 1e9:.3f} GB); peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    check(res.indices.shape == (B, K), "query_batch indices shape")
    for f in ("est_rank", "r_lo", "r_up", "R_lo_k", "R_up_k"):
        check(bool(torch.isfinite(getattr(res, f)).all()),
              f"non-finite {f}")
    check(torch.equal(res1.indices, res.indices[0])
          and torch.equal(res1.r_lo, res.r_lo[0])
          and torch.equal(res1.est_rank, res.est_rank[0]),
          "query(q) differs from row 0 of query_batch (K1 computes each "
          "query's scores the same way at any B)")

    dense = ReverseKRanksEngine(users, eng.rank_table, cfg, backend="dense")
    res_d = dense.query_batch(qs, K, C)
    rt = eng.rank_table
    f_bounds = ops.bound_ranks_batched(users, qs, rt.thresholds, rt.table,
                                       m=M)
    d_bounds = query_mod.bound_ranks_batch(rt, users, qs)
    n_diff, est_tol = selections_agree(torch, query_mod, res, res_d,
                                       f_bounds, d_bounds, K, C, M)

    accs, ratios, accs_d, ratios_d = [], [], [], []
    for b in range(B):
        tr = truth[b].cpu().numpy()
        ex = exact_idx[b].cpu().numpy()
        accs.append(metrics.accuracy(res.indices[b].cpu().numpy(), ex, tr, C))
        ratios.append(metrics.overall_ratio(res.indices[b].cpu().numpy(),
                                            ex, tr))
        accs_d.append(metrics.accuracy(res_d.indices[b].cpu().numpy(), ex,
                                       tr, C))
        ratios_d.append(metrics.overall_ratio(
            res_d.indices[b].cpu().numpy(), ex, tr))
    mean = lambda xs: sum(xs) / len(xs)
    print(f"  fused vs dense: {n_diff} users selected by one backend only, "
          f"all explained (est tolerance {est_tol:.3g})")
    print(f"  §5 fused: accuracy {mean(accs):.4f} overall ratio "
          f"{mean(ratios):.4f}; dense: accuracy {mean(accs_d):.4f} overall "
          f"ratio {mean(ratios_d):.4f} (mean over {B} queries, k={K}, c={C})")
    print(f"  guaranteed in {int(res.guaranteed.sum())} of {B} queries; "
          f"item {QUERY_ITEM}: indices {res1.indices.tolist()}")
    for a, r in zip(accs, ratios):
        check(0.0 <= a <= 1.0 and r >= 1.0 and r == r, "metrics out of range")
    # steady state, CUDA events around 10 calls each: the whole query and
    # its selection (steps 2-3) alone on the same bounds
    qb_steady = time_ms(torch, lambda: eng.query_batch(qs, K, C), reps=10)
    q1_steady = time_ms(torch, lambda: eng.query(items[QUERY_ITEM], K, C),
                        reps=10)
    sel_steady = time_ms(torch, lambda: query_mod.select_topk(
        *f_bounds, k=K, c=C, m_items=M), reps=10)
    print(f"  steady state: query_batch(B={B}) {qb_steady:.3f} ms, of which "
          f"selection {sel_steady:.3f} ms; query {q1_steady:.3f} ms")

    # 4b. the storage tier on the same data
    print(f"phase: storage tier, bf16 and int8, same data and samples, "
          f"B={B}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    tier = {}
    for spec in ("bf16", "int8"):
        cfg_s = RankTableConfig(tau=TAU, omega=OMEGA, s=S_PER,
                                storage_dtype=spec)
        t0 = time.perf_counter()
        eng_s = ReverseKRanksEngine.build(users, items, cfg_s, None,
                                          backend="fused", device=dev,
                                          positions=pos, weights=w)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res_s = eng_s.query_batch(qs, K, C)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        res1_s = eng_s.query(items[QUERY_ITEM], K, C)
        dense_s = ReverseKRanksEngine(users, eng_s.rank_table, cfg_s,
                                      backend="dense")
        res_sd = dense_s.query_batch(qs, K, C)
        res1_sd = dense_s.query(items[QUERY_ITEM], K, C)
        torch.cuda.synchronize()
        tier[spec] = dict(cfg=cfg_s, eng=eng_s, dense=dense_s, res=res_s,
                          res1=res1_s, res_d=res_sd, res1_d=res1_sd,
                          build_s=t1 - t0, qb_ms=(t2 - t1) * 1e3)
    counts_q = dict(ops.LAUNCHES)
    peak_tier = torch.cuda.max_memory_allocated()
    print(f"  launches on the storage-tier path: {counts_q}")
    for name in ("k2_table_build", "k4_bound_ranks_bf16",
                 "k5_bound_ranks_int8"):
        check(counts_q[name] >= 1,
              f"kernel {name} was not launched on the storage-tier path")
    print(f"  peak allocated over the storage-tier path (both specs' "
          f"builds and queries, beside the f32 engine) "
          f"{peak_tier / 1e9:.2f} GB")

    for spec, t in tier.items():
        cfg_s, eng_s, res_s, res_sd = t["cfg"], t["eng"], t["res"], t["res_d"]
        packed = cfg_s.storage.pack_table(rt.thresholds, rt.table, m=M)
        for f in packed._fields:
            a, b = getattr(eng_s.rank_table, f), getattr(packed, f)
            check(a == b if f == "m" else (a is None and b is None)
                  or torch.equal(a, b),
                  f"{spec}: rank table field {f} is not pack_table of the "
                  "f32 build's arrays")
        su_want = cfg_s.storage.pack_users(users)
        for f in su_want._fields:
            a, b = getattr(eng_s.stored_users, f), getattr(su_want, f)
            check((a is None and b is None) or torch.equal(a, b),
                  f"{spec}: stored users field {f} is not pack_users")
        del packed, su_want
        mem_s = eng_s.memory_bytes()
        expect = {"bf16": N * (4 * TAU + 2 * D + 4),
                  "int8": N * (2 * TAU + 5 * 4 + D + 2 * 4)}[spec]
        print(f"  {spec}: build {t['build_s']:.3f} s (host clock, K2 + "
              f"pack), packs equal pack_table/pack_users of the f32 "
              f"arrays; first query_batch {t['qb_ms']:.2f} ms; "
              f"memory_bytes {mem_s} ({mem_s / mem:.3f} of f32's {mem})")
        check(mem_s == expect, f"{spec}: memory_bytes {mem_s} != {expect}")

        check(res_s.indices.shape == (B, K), f"{spec}: indices shape")
        for r in (res_s, res_sd):
            for f in ("est_rank", "r_lo", "r_up", "R_lo_k", "R_up_k"):
                check(bool(torch.isfinite(getattr(r, f)).all()),
                      f"{spec}: non-finite {f}")
        kid = 4 if spec == "bf16" else 5
        check_containment(torch, res_s, res, f"{spec} fused (K{kid}) vs "
                          "f32 K1")
        check_containment(torch, res_sd, res, f"{spec} dense vs f32 K1")
        # K4/K5 compute each query's score the same way at any B: with one
        # ‖q‖₁ shared by both launches, query 0 alone equals column 0 of
        # the 16. The fused query(q) is then row 0 of query_batch wherever
        # ‖q‖₁ comes out of the reduction the same for one query as for
        # 16 (the dense path's product is not bitwise across B)
        qn = query_mod.query_l1(qs)
        one = quant_launches(torch, ops, eng_s.stored_users, qs[:1], qn[:1],
                             eng_s.rank_table)
        all16 = quant_launches(torch, ops, eng_s.stored_users, qs, qn,
                               eng_s.rank_table)
        check(all(torch.equal(a[:, 0], b[:, 0]) for a, b in zip(one, all16)),
              f"{spec}: K{kid} query 0 at B=1 differs from B=16 with the "
              "same ‖q‖₁")
        del one, all16
        same_l1 = bool(qn[0] == query_mod.query_l1(qs[:1])[0])
        r1 = t["res1"]
        if same_l1:
            check(torch.equal(r1.indices, res_s.indices[0])
                  and torch.equal(r1.r_lo, res_s.r_lo[0])
                  and torch.equal(r1.r_up, res_s.r_up[0])
                  and torch.equal(r1.est_rank, res_s.est_rank[0]),
                  f"{spec}: query(q) differs from row 0 of query_batch")
        dense_row0 = bool(torch.equal(t["res1_d"].indices,
                                      res_sd.indices[0]))
        su = eng_s.stored_users
        f_b = ops.bound_ranks_batched_stored(su, qs, eng_s.rank_table)
        d_b = query_mod.bound_ranks_batch(eng_s.rank_table, su, qs)
        n_diff, tol_s = selections_agree(torch, query_mod, res_s, res_sd,
                                         f_b, d_b, K, C, M)
        del f_b, d_b
        accs, ratios = {"fused": [], "dense": []}, {"fused": [], "dense": []}
        for b in range(B):
            tr = truth[b].cpu().numpy()
            ex = exact_idx[b].cpu().numpy()
            for name, r in (("fused", res_s), ("dense", res_sd)):
                idx_b = r.indices[b].cpu().numpy()
                accs[name].append(metrics.accuracy(idx_b, ex, tr, C))
                ratios[name].append(metrics.overall_ratio(idx_b, ex, tr))
        for a, r in zip(accs["fused"], ratios["fused"]):
            check(0.0 <= a <= 1.0 and r >= 1.0 and r == r,
                  f"{spec}: metrics out of range")
        print(f"  {spec} fused vs dense: {n_diff} users selected by one "
              f"backend only, all explained (est tolerance {tol_s:.3g}); "
              f"§5 fused: accuracy {mean(accs['fused']):.4f} overall ratio "
              f"{mean(ratios['fused']):.4f}; dense: accuracy "
              f"{mean(accs['dense']):.4f} overall ratio "
              f"{mean(ratios['dense']):.4f} (graded by phase 4's K3 ranks); "
              f"guaranteed in {int(res_s.guaranteed.sum())} of {B}; item "
              f"{QUERY_ITEM}: {r1.indices.tolist()}; fused query(q) = row "
              f"0 of query_batch checked: {same_l1} (K{kid} query 0 at B=1 "
              "= B=16 with one ‖q‖₁: checked); "
              f"dense query(q) selects row 0's users: {dense_row0}")
        qb_st = time_ms(torch, lambda: eng_s.query_batch(qs, K, C), reps=10)
        q1_st = time_ms(torch, lambda: eng_s.query(items[QUERY_ITEM], K, C),
                        reps=10)
        qb_dn = time_ms(torch, lambda: t["dense"].query_batch(qs, K, C),
                        reps=5)
        print(f"  {spec} steady state: fused query_batch(B={B}) "
              f"{qb_st:.3f} ms, query {q1_st:.3f} ms; dense query_batch "
              f"{qb_dn:.3f} ms")

    # 5. kernels against plain versions on the main path's inputs, timed
    print("phase: kernels vs plain at the main path's shapes, timed")
    thr, tab = rt.thresholds, rt.table
    items_sorted, _ = rt_mod.sort_items_by_norm(items)
    samples = items_sorted[pos].contiguous()
    out = []

    def row(name, replaces, launches, err, ms, plain_ms, bound_bytes,
            bound_ops, source):
        t_bytes = bound_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = bound_ops / FP32_FLOP_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        rec = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": None}
        print(f"  {name}: {ms:.3f} ms (plain {plain_ms:.3f} ms, bound "
              f"{bound:.3f} ms by {rec['bound_by']}, "
              f"{bound / ms * 100:.1f}% of bound), launches {launches}")
        out.append(rec)

    src = "src/repro_torch/kernels/csrc/"
    for nb, replaces in ((B, "src/repro/kernels/user_scores.py:137"),
                         (1, "src/repro/kernels/user_scores.py:57")):
        q = qs[:nb].contiguous()
        err = check_k1(torch, ops, ref, users, q, thr, tab, M,
                       f"Netflix B={nb}")
        ms = time_ms(torch, lambda: ops.bound_ranks_batched(
            users, q, thr, tab, m=M), reps=20)
        pms = time_ms(torch, lambda: ref.ref_bound_ranks(
            users, q, thr, tab, M), reps=5)
        # least bytes: U and Q once; per user, a search of the sorted
        # thresholds row and the table sectors this run's lookups touch;
        # outputs
        idx = query_mod._bucketize(thr, users @ q.T)
        k1_bytes = (4 * (N * D + nb * D) + N * search_bytes(4 * TAU, nb)
                    + gather_bytes(torch, idx, TAU, 4) + 12 * N * nb)
        del idx
        row(f"k1_bound_ranks[B={nb}]", replaces, counts["k1_bound_ranks"],
            err, ms, pms, k1_bytes,
            2 * N * D * nb + N * nb * math.ceil(math.log2(TAU)),
            src + "user_scores.cu")

    table_k2, err = check_k2(torch, ops, ref, users, samples, w, thr,
                             "Netflix")
    check(torch.equal(table_k2, tab), "K2 is not deterministic: the main "
          "path's table differs from a second launch")
    ms = time_ms(torch, lambda: ops.build_table_rows(users, samples, w, thr),
                 reps=5)
    pms = time_ms(torch, lambda: ref.ref_table_rows(users, samples, w, thr),
                  reps=1)
    est_ms = time_ms(torch, lambda: ref.estimate_table_rows(
        users @ samples.T, w, thr), reps=3)
    print(f"  K2's sort + suffix-sum form (the wrapper's CPU path) on the "
          f"card: {est_ms:.3f} ms")
    S = samples.shape[0]
    row("k2_table_build", "src/repro/kernels/table_build.py:28",
        counts["k2_table_build"], err, ms, pms,
        4 * (N * D + S * D + S + 2 * N * TAU), 2 * N * S * D,
        src + "table_build.cu")

    errs, n_diffs = [], 0
    for b in range(B):
        _, nd, e = check_k3(torch, ops, ref, users, items, qs[b], "Netflix",
                            got=truth[b])
        errs.append(e)
        n_diffs += nd
    print(f"  K3 Netflix: {B} queries, {n_diffs} of {B * N} ranks differ "
          f"from the plain version, all explained; max abs err {max(errs)}")
    q0 = qs[0]
    ms = time_ms(torch, lambda: ops.exact_ranks(users, items, q0), reps=3)
    pms = time_ms(torch, lambda: ref.ref_exact_counts(users, items, q0),
                  reps=3)
    row("k3_exact_ranks", "src/repro/kernels/exact_rank.py:25",
        counts["k3_exact_ranks"], max(errs), ms, pms,
        4 * (N * D + M * D + D + N), 2 * N * M * D, src + "exact_rank.cu")

    probes = math.ceil(math.log2(TAU))
    for spec, name, line in (("bf16", "k4_bound_ranks_bf16", 295),
                             ("int8", "k5_bound_ranks_int8", 347)):
        eng_s = tier[spec]["eng"]
        rt_s, su = eng_s.rank_table, eng_s.stored_users
        rows, uscale, uslack = ops.stored_parts(su, spec)
        for nb in (B, 1):
            q = qs[:nb].contiguous()
            qn = query_mod.query_l1(q)
            err, _ = check_quant(torch, ops, ref, query_mod, su, q, rt_s,
                                 f"{name} Netflix B={nb}")
            ms = time_ms(torch, lambda: ops.bound_ranks_batched_stored(
                su, q, rt_s), reps=20)
            pms = time_ms(torch, lambda: ref.ref_bound_ranks_stored(
                rows, uscale, uslack, q, qn, rt_s), reps=5)
            # least bytes: the stored rows, the per-user vectors, Q and
            # ‖q‖₁ once; per user K4's search of the thresholds row (one
            # per query, shared by its two keys), the table sectors this
            # run's lookups touch, and the outputs
            indices = {"bf16": query_mod.bf16_indices,
                       "int8": query_mod.int8_indices}[spec]
            idx_lo, idx_hi = indices(
                rt_s, query_mod._dequant_matmul(rows, uscale, q),
                uslack * qn[None, :])
            if spec == "bf16":
                need = (2 * N * D + 4 * N + N * search_bytes(2 * TAU, nb)
                        + gather_bytes(torch, idx_hi, TAU, 2, idx_lo))
                flops = 2 * N * D * nb + 2 * N * nb * probes
            else:
                need = (N * D + 28 * N
                        + gather_bytes(torch, idx_hi, TAU, 1, idx_lo))
                flops = 2 * N * D * nb + 20 * N * nb
            del idx_lo, idx_hi
            need += 4 * (nb * D + nb) + 12 * N * nb
            row(f"{name}[B={nb}]", f"src/repro/kernels/user_scores.py:{line}",
                counts_q[name], err, ms, pms, need, flops,
                src + "user_scores_quant.cu")
    return out


if __name__ == "__main__":
    sys.exit(main())
