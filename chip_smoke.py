#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --digests SRC   # another tree's outputs, below

Phases, each fatal on failure (exit code 1, no result line):

  1. device line: the card's name and power limit, torch and CUDA;
  2. build K1-K7 from `src/repro_torch/kernels/csrc/*.cu` with nvcc, and
     print the launch K4/K5/K7 make at the main path's sizes (rows a
     tile of their shared-memory ring, stages, shared memory, blocks an
     SM) with each instance's registers and local memory, K1/K6's the
     same at d = 200 and at the depths phase 3 drives, and K3's (its
     tile, ring stages, shared memory, blocks an SM, registers, local
     memory) at d = 200 and at the depths phase 3 drives, and K2's (its
     product's tile, ring stages, shared memory, blocks an SM, registers
     and local memory, the count's, the users a chunk and the workspace);
  3. each kernel against its plain PyTorch version on the card at ragged
     shapes (K4/K5 on integer inputs, where they must agree exactly, with
     stored and with raw f32 users; and on randn inputs, where query 0
     must come out bitwise the same at every query count given the same
     ‖q‖₁); K1-K5 again at d = 1,031, past every former shared-memory
     cap (Qᵀ streamed, K3's user tile and K2's depth cut); K6/K7 against
     K1/K4/K5 on the same rows (bitwise, B in 1, 3, 16, 19, with a
     partial tail tile, duplicate ids and a single tile) and against
     their plain versions; K3 at its edges (d = 37, the last depth of its
     resident user tile and the next, d = 1,031; views U[1:] and P[1:]
     and rows 4 bytes off a 16-byte boundary; q in P and a random q) by
     the explained-mismatch rule and bitwise on integer inputs; K4/K5/K7
     on views at an offset (every staged array from row 1 on, d = 37),
     bitwise the same call on copies, and on rows of d = 30,000 (raw f32
     rows stream through the ring in chunks), bitwise their plain
     versions on integer inputs; K2 at its edges (S = 40, 640, 777 and
     4,096, tau = 1 to 1,031, d = 37, the last resident depth of its
     product and the next, 1,031; rows of thresholds ascending,
     descending and shuffled; views from row 1; ties and +-0.0) bitwise
     its plain version on integer inputs with integer, equal dyadic and
     runs-of-64 weights, two launches equal, and by the explained-mismatch
     rule with random weights on shuffled rows; K1/K6 at the edges of
     their ring (`k1_edges`: n about a tile, d = 1 to 30,000, tau = 1 to
     30,000, B = 1 to 19, runs of equal thresholds with scores on them
     and off the grid, views from row 1, K6 at block_n 256 and 100 with a
     tail tile and duplicate ids) bitwise their plain versions on integer
     inputs; the elastic entries of K1, K4 and K5, which read their row
     count on the device (`elastic_entry_checks`: every kind, B = 1, 16
     and 19, n_valid = 1, T - 1, T + 1, n and the capacity), rows below
     n_valid bitwise the existing entries and the plain versions' bounds
     on integer inputs, rows past it unwritten;
     and the port's engine on the card against the same engine on the
     CPU at a small size, at each spec;
  4. the main path at the paper's Netflix size (n = 480,189 users,
     m = 17,770 items, d = 200; tau = 500, omega = 10, s = 64), on
     synthetic embeddings from a seed: Algorithm 1 build on the fused
     backend (K2), query_batch of 16 item queries and one query (K1),
     exact grading of those queries through K3 with the §5 accuracy and
     overall ratio, held against the dense backend, and a torch.profiler
     breakdown of the fused query and query_batch. The launch counts are
     zeroed just before and read just after; each kernel must have run.
     Then the SHA-256 digests of the f32 build's table (K2), of K1's
     (r_lo, r_up, est) at B = 16 and 1, and of what the 32 K3 launches
     gave (the 16 rank vectors, then the 16 reverse_k_ranks (indices,
     ranks) pairs);
  4b. the storage tier on the same data: builds at bf16 and int8 with the
     f32 build's samples (K2), whose packs must equal `pack_table` /
     `pack_users` of the f32 arrays; query_batch and query on the fused
     backend (K4, K5) and on dense; certified containment of every
     (query, user) bound in the f32 engine's K1 bounds; the §5 metrics
     against the exact ranks of phase 4; memory_bytes; the fused
     query(q) equal to row 0 of query_batch. Its own launch counts,
     zeroed before and read after; K4 and K5 must have run; then the
     SHA-256 digest of K4/K5's and of K7's (r_lo, r_up, est) at bf16 and
     int8, stored and raw f32 rows, B = 16 and 1 (K7 over a fixed tile
     list with duplicates and the tail block), for comparison with
     another tree's digests on the same inputs (`quant_digests`), and
     a torch.profiler breakdown of each quantized query_batch;
  4c. block-pruned queries: (i) the same data built with
     cluster_reorder=True on pruned:fused at the default cap, whose
     selection must be bitwise the full-scan fused engine's on the same
     rows; (ii) the pruned path forced (max_union_frac=1.0) at f32, bf16
     and int8, where K6 and K7 must launch (its own launch counts), the
     selection must be the full scan's and query(q) row 0 of
     query_batch, and the digests of K6's outputs over its kept tiles at
     B = 16 and 1; (iii) the mid_mixture regime reordered, with a
     hot-cluster batch: skip rate and time beside the full scan;
  4d. the mutable index (`mutable_index_checks`): its own draw at Netflix
     size (m + 96 items, the last 96 held out for insertion), fused
     engines at f32, bf16 and int8 built with seed BUILD_SEED, then the
     churn (+96 items, -64 base items, 32 users upserted, 32 appended,
     48 deleted) on them, on phase 4c's reordered engines and on the
     mid_mixture engine. Checks: (a) f32 delta
     bounds = clip(static K1 bounds + a brute-force count shift over
     the same score products, 1, m' + 1), dead rows +inf; (b) bf16 and
     int8 delta bounds contain the f32 ones; (c) fused delta selects as
     dense delta; (d) pruned:fused and pruned:dense select bitwise the
     inner delta full scan; (e) insert, delete, rebuild() is a scratch
     build with the same seed over the live items; (f) upserted rows
     within rtol 1e-6 of a scratch build over the modified users, the
     rest bitwise; (g) launch counts per step, each in a window of its
     own that holds none of the checks' direct wrapper calls, exactly:
     the churn K2 once an upsert; the delta queries K1, K4 and K5; each
     pruned:fused delta query K6 or K7 once, pruned:dense nothing;
     grading K3. Printed: the §5 metrics of the mutated and the rebuilt
     engine over the live users and items (K3), static against delta
     query times with their torch.profiler breakdowns and
     `correction_overhead()`, each mutation's host time (the process's
     first calls, which load their kernels, and warm ones) and the
     rebuild's, each f32 mutation's peak device memory above what was
     held before it, `memory_bytes()`, and the digest of the f32 fused delta
     bounds (`digest delta`);
  5. each kernel against its plain version on the main path's inputs,
     and their times beside the card's bound (K6/K7 on phase 4c (ii)'s
     kept tiles, bounded over the kept rows; K1, K4 and K5 also their
     launches alone); beside K3, the time of
     torch.matmul of the same (n, d) x (d, m) f32 product, TF32 off, in
     user blocks of 32,768, summed over the blocks: the f32 rate the card
     reaches at its power limit, not K3's function (it writes every
     score and counts nothing), and not called by the port;
  6. the serving path at Netflix size (`serving_checks`), its own launch
     counts zeroed before and read after (the elastic entries of K1, K4
     and K5 must have run, in replays of CUDA graphs): (a) elastic:fused
     bitwise the fused engines of phases 4 and 4b in query_batch and
     query at c = 2.0 and 1.3; (b) elastic:dense against dense by the
     explained-mismatch rule; (c) elastic_trace_count() flat across an
     n sweep inside the bucket (450,000, 470,000, 480,189 -> capacity
     524,288), a change of c, item churn on the delta path, appends and
     a rebuild growing n, and one more for n in a new bucket, with a
     replay's bounds bitwise a direct call of the entry; (d) MicroBatcher
     on elastic:fused, max_batch 16, pipeline depth 1 and 2, 512 item
     queries from 4 client threads, every result bitwise its row of a
     synchronous query_batch, with latency, fill, each tick's copy of the
     result to the host (time and bytes), compiles, overlap and
     queries/s; (e) cached:elastic:fused admission hits; (f) a
     serve.transfer fault failing exactly its tick; (g) close(drain_s)
     with ticks in flight; then the elastic entries on the padded
     operands at n_valid = n, timed beside the existing entries at n,
     and the peak device memory.
  7. durability, the maintenance loop and the quality auditor
     (`durability_checks`), in a spill directory from tempfile.mkdtemp()
     whose free bytes must hold three f32 spills: (a) phase 4d's data and
     churn on f32 and int8 fused engines built with BUILD_SEED under an
     IndexPersister, with the spill's bytes and its stages' times and
     each WAL append's latency; `restore` on the card bitwise the running
     engine (epoch, users, every RankTable field, delta state, stored
     users, correction, sampling and generator state, user_remap,
     query_batch and query), and bitwise again after both rebuild; (b)
     the rebuild's swap_s with and without a persister, and the wait of
     an insert issued during the rebuild's locked spill; (c) a
     MaintenanceLoop with a persister on a mutable elastic:fused engine
     while 4 client threads serve through MicroBatcher (depth 2) and 96
     items go in in 4 batches: one rebuild, one program built for each
     new key (the delta widths 32, 64, 128, then the static path at
     m + 96) and none per tick, every result bitwise its snapshot's
     synchronous query_batch; (d) a QualityAuditor at fraction 1.0 on
     phase 4's queries, equal to phase 4's own §5 grades (rtol 1e-12),
     one K3 launch a sample, on the auditor's stream; (e) phase 6's burst
     without an auditor, with one at fraction 0.05, and with one and the
     dispatch stream at priority 0 in place of the scheduler's -1:
     queries/s, p50/p99, backlog, flush
     time, K3 launches = samples scored; (f) phase 4c (iii)'s engine:
     the prune_skip_rate gauge equals stats.skip_rate, and the prune.*
     span times beside the query's.
  8. row-sharded execution and the QSRP baseline (`sharded_checks`), P
     shards on the one card (a mesh that repeats it): (a) the sharded
     query at n over 3 shards on phase 4's f32 table and phase 4b's int8
     one, B = 16 and item 42, bitwise select_topk over the shards' own
     bounds, R_k equal to the single-device dense path's and at least
     k - 1 shared indices a query, one step of each collective a call,
     and build_index at n and m taking the dense fallback; (b)
     build_sharded on the first N_CUT = 479,232 users over 2 shards at
     f32 and int8 against build_rank_table on the same rows, K2 launched
     twice against once; (c) pruned:sharded on phase 4c (iii)'s
     mid_mixture draw cut to N_CUT, bitwise the unpruned sharded query,
     and the align fallback at n; (d) ring_exact_ranks on the cut users,
     bitwise phase 4's exact ranks, 4 K3 launches a query; (e) QSRP at n
     (levels 1,000): build time, peak memory and bytes, then every query
     at c = 1 and 2, ranks exact, accuracy 1, n_refined not growing
     with c. Prints `digest sharded`.
  9. the entry points as a user runs them (`entry_point_checks`), each
     a subprocess under a finder that blocks JAX and the reference,
     finding the kernels phase 2 built: (a) `python -m
     repro_torch.launch.serve --backend fused` at Netflix size, 512
     queries: the f32 index bytes, all served, the latency histogram's
     count, the §5 grades; (b) int8 behind elastic:fused: one program;
     (c) with the update stream, persistence and the auditor: a
     rebuild, an audit, then `restore` with m + 4 items a batch; (d) a
     long run scraped at `/metrics`, then SIGTERM: exit 0 within the
     drain bound plus a spill, `restore`; (e) `--mf` at the Netflix
     Prize's 100,480,507 ratings: the loss falls, d = 202; two trainings
     at 10,000,000 ratings bitwise equal, the ratings bitwise unchunked;
     (f) the three examples at their reference sizes, at once. Each run
     prints its wall time, the launches its wrappers made (counted from 0
     in its own process) and its peak device memory.
  10. the LM substrate's serving path (`lm_checks`): (a) gemma-2b at its
     published size, parameters from a seeded generator on the card:
     prefill of 8 prompts of 2,048 tokens (the chunked attention),
     teacher-forced decode of each prompt's first 64 tokens through a
     cache of 2,080 slots (argmax agreement with the prefill >= 0.8, the
     reference's criterion; the largest logit difference), 32 greedy
     tokens: prefill tokens/s, ms a decode step, peak memory; (b) the
     other nine architectures at full width and the `reduced` rule's
     depth, each a prefill of 2 x 64 and the same check (MoE at capacity
     factor = n_experts, then finite at its own), each freed before the
     next; (c) step 4 of `examples/serve_retrieval.py` with gemma-2b:
     32,768 user and 4,096 item sequences of 16 tokens encoded 512 at a
     time, the engine built (K2), 16 items queried (K1) and graded (K3),
     each kernel's launches counted exactly in that window; then K1 (B =
     1), K2 and K3 against their plain versions at d = 2,048, timed
     beside their bounds (rows `...[d=2048]` of the kernels line), and
     beside K3 the f32 product alone at d = 2,048 (`matmul_ms`, as in
     phase 5: a yardstick, not K3's function).
  11. the LM substrate's training path (`train_checks`): (a) `python -m
     repro_torch.launch.train --arch gemma-2b --full-config
     --global-batch 2 --seq-len 2048 --steps 12` under the import
     blocker (18 layers, d_model 2,048, vocab 256,000, remat "nothing",
     bf16 compute params): exit 0, every loss and grad norm finite; the
     loss of each step, s a step after the first, tokens/s, peak memory;
     (b) gemma-2b at full width and 2 layers in this process, 2 x 2,048
     tokens: the first step's loss against a plain f32 CE with the
     z-loss over `forward_logits` on the same bf16 copy (1e-3
     relative), microbatches=2 gradients within 5 % relative L1, one
     step run twice bitwise, vocab_chunks=8 within 5e-3 of the dense loss
     (each one's peak memory); (c) one train step of each other
     architecture at `reduced()`: finite, bf16 against f32 compute params
     within 0.05, MoE under both dispatches within 1e-3; (d) kill and
     resume at `examples/train_lm`'s ~79 M config: 8 steps here against
     4 + 4 in two fresh processes, losses and the final checkpoint
     bitwise, the checkpoint's bytes, save and restore seconds; (e)
     `python -m repro_torch.examples.train_lm` under the blocker: a loss
     drop > 0.3, ms a step. It launches no kernel of the port.
  12. the LM substrate's sharding (`sharded_lm_checks`), each part in a
     subprocess under the import blocker: (a) a single-rank NCCL process
     group and a 1x1 ("data", "model") mesh on the card;
     `launch.train.run_training` of gemma-2b at its published size, 4
     steps of 2 x 2,048 tokens, on the mesh and without one from the
     same seed, sharded, plain, plain, sharded: the loss streams, grad
     norms and every final parameter bitwise equal, each leaf on its
     `param_specs` placements (a mesh dim of one rank replicates); s a
     step after the first, tokens/s, peak memory and the host time of a
     step's call for each run, gemma-2b's
     `model_flops_train` of a step and its share of the dense bf16 peak;
     (b) gemma-2b at full width and 2 layers: 2 sharded steps with a
     checkpoint, restored through `shardings=` onto the 1x1 mesh and
     through `device=` without one, the next step's loss equal; (c),
     once (a) and (b) have ended, `python -m repro_torch.launch.dryrun
     --arch gemma-2b --both-meshes --engine` (fake process groups of 256
     and 512 ranks, and the engine's build, query and ring at AMAZON_K on
     flat meshes of as many shards; no card memory): exit 0, the
     `roofline_report --md` table,
     each cell's three terms, bottleneck and whether its bytes a device
     fit 80 GB. The card runs only the 1x1 mesh: NCCL puts one rank on a
     card, and the machine has one.

`--digests SRC` runs only phase 4's data, its f32 build, K3 grading,
phase 4c's reordered f32 engine and the storage tier's tables with the
package under SRC (another tree's `src`, built in that tree), and prints
the K2, K1 and K3 digests, the torch.profiler breakdown of the f32 fused
query and query_batch, the sharded digest of phase 8 (n/a for a package
without the sharded backend), the K6 digests, the 16 K4/K5/K7 digests of
phase 4b and phase 4d's delta digest (n/a for a package without the
mutable index), for comparison with this tree's in one call.

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

import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.paper_engine import DEFAULT_TABLE, NETFLIX  # noqa

N, M, D = NETFLIX.n_users, NETFLIX.n_items, NETFLIX.d
TAU, OMEGA, S_PER = DEFAULT_TABLE.tau, DEFAULT_TABLE.omega, DEFAULT_TABLE.s
S_MAIN = OMEGA * S_PER             # samples of the build (K2)
K, C, B = 10, 2.0, 16
D_WIDE = 1031                      # past every former shared-memory cap
D_LONG = 30_000                    # raw f32 rows past two ring stages
QUERY_ITEM = 42                    # the item examples/quickstart.py queries
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12            # H100 SXM, f32 outside the tensor cores
U24 = 2.0 ** -24


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# Phase 9 runs the port's entry points in subprocesses that cannot import
# JAX or the reference (the finder of tests/test_torch_imports.py). The
# runner takes a module to run as `python -m` would, with its arguments,
# or `-c` and a statement; when it returns, the runner prints the kernel
# launches the process made (its counts start at 0), the seconds each
# kernel's build took (0 where the library was already built), the peak
# device memory and any module of JAX or the reference that got loaded.
RUNNER = r"""
import importlib.abc, json, runpy, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
try:
    if sys.argv[1] == "-c":
        exec(sys.argv[2])
    else:
        sys.argv = sys.argv[1:]
        runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
finally:
    import torch
    from repro_torch.kernels import _build, ops
    print("runner: " + json.dumps({
        "launches": {k: v for k, v in ops.LAUNCHES.items() if v},
        "built_s": {k: r["seconds"] for k, r in _build.BUILD_INFO.items()},
        "peak_bytes": (torch.cuda.max_memory_allocated()
                       if torch.cuda.is_initialized() else None),
        "leaked": sorted(m for m in sys.modules if m.split(".")[0] in
                         ("jax", "jaxlib", "ml_dtypes", "repro"))}),
        flush=True)
"""


def run_blocked(*args: str, timeout: float, popen: bool = False):
    """Run RUNNER with `args` in a fresh interpreter, unbuffered, with this
    tree's `src` first on the path: a finished `CompletedProcess`, or
    with popen=True the running `Popen` (text pipes)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    cmd = [sys.executable, "-u", "-c", RUNNER, *args]
    if popen:
        return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    return subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def runner_report(stdout: str) -> dict:
    """The runner's closing record in a subprocess's output."""
    lines = [ln for ln in stdout.splitlines() if ln.startswith("runner: ")]
    check(lines, "the runner printed no record")
    return json.loads(lines[-1][len("runner: "):])


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


def check_k1(torch, ops, ref, users, qs, thr, tab, m, label, got=None,
             name="K1"):
    """K1 against its plain version under the explained-mismatch rule;
    `got` (user-major (n, B) outputs) holds another launch's result for
    these rows, such as K6's kept rows (`name` "K6")."""
    if got is None:
        got = [x.T for x in ops.bound_ranks_batched(users, qs, thr, tab,
                                                    m=m)]
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
          f"{name} {label}: {int(unexplained.sum())} bound mismatches not "
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
            f"{name} {label}: {int(bad_est.sum())} est cells beyond tolerance "
            f"(max err {float(est_err[bad_est].max()):.3g})")
    for x in got:
        check(bool(torch.isfinite(x).all()),
              f"{name} {label}: non-finite output")
    max_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    same = ~bounds_differ
    est_same = float(est_err[same].max()) if bool(same.any()) else 0.0
    print(f"  {name} {label}: n={users.shape[0]} d={users.shape[1]} "
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
    same = ~flips & torch.isfinite(d_bounds[2])     # deleted users: +inf
    tol = float((f_bounds[2] - d_bounds[2])[same].abs().max())
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


K1_EDGE_CASES = ("tile", "depth", "tau", "queries", "ties", "views", "k6")


def k1_exact(torch, ops, ref, users, qs, thr, tab, m, label):
    """K1 against its plain version on integer inputs (every score exact
    in any order): r_lo/r_up bitwise, est within 1e-5 relative. Returns
    K1's (r_lo, r_up, est), each (B, n)."""
    got = ops.bound_ranks_batched(users, qs, thr, tab, m=m)
    want = ref.ref_bound_ranks(users, qs, thr, tab, m)
    torch.cuda.synchronize()
    check(torch.equal(got[0], want[0].T) and torch.equal(got[1], want[1].T),
          f"K1 {label}: bounds differ from the plain version on integer "
          "inputs")
    err = (got[2] - want[2].T).abs()
    check(bool((err <= 1e-5 * want[2].T.abs()).all()),
          f"K1 {label}: est beyond 1e-5 relative (max err "
          f"{float(err.max())})")
    return got


def k1_edge_inputs(torch, g, n, d, tau, m=777, ties=False):
    """Integer users (n, d) and items (m, d), and per user an ascending
    thresholds row (n, tau) and a descending table row: integer and
    half-integer thresholds (integer ones tie integer scores); with
    `ties`, thresholds drawn from the user's own scores in runs of three
    equal values, rows 0-9 above every score and rows 10-19 below."""
    dev = g.device
    users = torch.randint(-4, 5, (n, d), generator=g, device=dev).float()
    items = torch.randint(-4, 5, (m, d), generator=g, device=dev).float()
    top = int(4 * 4 * d) + 2
    thr = (torch.randint(-top // 4, top // 4 + 1, (n, tau), generator=g,
                         device=dev)
           + 0.5 * torch.randint(0, 2, (n, tau), generator=g, device=dev))
    if ties:
        sc = users @ items[:19].T
        own = torch.gather(sc, 1, torch.randint(0, 19, (n, tau), generator=g,
                                                device=dev))
        thr = torch.where(torch.rand((n, tau), generator=g, device=dev) < 0.5,
                          own, thr)
        thr = torch.repeat_interleave(thr[:, :(tau + 2) // 3], 3,
                                      dim=1)[:, :tau]
        k = min(10, n)
        step = torch.arange(tau, device=dev).float()
        thr[:k] = sc[:k].max(dim=1, keepdim=True).values + 1.0 + step
        thr[k:2 * k] = sc[k:2 * k].min(dim=1, keepdim=True).values - 1.0 \
            - tau + step
    thr = torch.sort(thr.float(), dim=1).values.contiguous()
    tab = torch.flip(torch.cumsum(torch.rand((n, tau), generator=g,
                                             device=dev), 1), [1]) + 1.0
    return users, items, thr, tab.contiguous()


def k1_edges(torch, ops, ref, user_scores, pruning, case):
    """K1 (and K6) at one edge of their ring, `case` of K1_EDGE_CASES,
    on the card: bounds bitwise the plain version's on integer inputs,
    est within 1e-5, query 0 bitwise the same at every B, K6's kept rows
    bitwise K1's. Raises SmokeFailure; returns a line to print."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(29 + K1_EDGE_CASES.index(case))
    m = 777
    if case == "tile":  # n below one tile and one past it
        tiles = []
        for nb in (1, 16):
            T = user_scores.launch_config(nb, 37, 37)["tile_rows"]
            tiles.append(T)
            for n in (max(1, T - 3), T + 1):
                u, it, thr, tab = k1_edge_inputs(torch, g, n, 37, 37)
                k1_exact(torch, ops, ref, u, it[:nb].contiguous(), thr, tab,
                         m, f"n={n} B={nb}")
        return f"tile: n three below and one past a tile ({tiles} rows)"
    if case == "depth":
        for d in (1, 37, 200, 1031, 30_000):
            n = 70 if d == 30_000 else 300
            u, it, thr, tab = k1_edge_inputs(torch, g, n, d, 33)
            for nb in (1, 3, 16):
                k1_exact(torch, ops, ref, u, it[:nb].contiguous(), thr, tab,
                         m, f"d={d} B={nb}")
        chunk = user_scores.launch_config(16, 30_000, 33)["row_chunk"]
        check(chunk < 30_000, "K1 rows of d=30,000 do not stream in chunks")
        return f"depth: d in 1, 37, 200, 1031, 30000 (chunks of {chunk})"
    if case == "tau":
        big = 30_000
        check(user_scores.launch_config(16, 37, big)["thresholds_staged"]
              == 0, f"tau={big}: the thresholds rows still fit a stage")
        check(user_scores.launch_config(16, 37, 500)["thresholds_staged"]
              == 1, "tau=500: the thresholds rows are not staged at B=16")
        for tau in (1, 2, 37, 500, 777, big):
            u, it, thr, tab = k1_edge_inputs(torch, g, 100 if tau == big
                                             else 300, 37, tau)
            for nb in (1, 2, 16):
                k1_exact(torch, ops, ref, u, it[:nb].contiguous(), thr, tab,
                         m, f"tau={tau} B={nb}")
        return f"tau: 1, 2, 37, 500, 777 and {big} (not staged)"
    if case == "queries":  # and query 0 bitwise at every B, integer and randn
        u, it, thr, tab = k1_edge_inputs(torch, g, 1000, 37, 37)
        ur = torch.randn((1000, 37), generator=g, device=dev)
        qr = torch.randn((19, 37), generator=g, device=dev)
        thr_r = torch.sort(torch.randn((1000, 37), generator=g, device=dev)
                           * 6.0, dim=1).values
        first = {}
        for nb in (1, 2, 3, 6, 16, 19):
            got = k1_exact(torch, ops, ref, u, it[:nb].contiguous(), thr, tab,
                           m, f"B={nb}")
            rnd = ops.bound_ranks_batched(ur, qr[:nb].contiguous(), thr_r,
                                          tab, m=m)
            for key, x in (("int", got), ("randn", rnd)):
                row0 = [y[0] for y in x]
                first.setdefault(key, row0)
                check(all(torch.equal(a, b) for a, b in
                          zip(row0, first[key])),
                      f"K1 {key}: query 0 at B={nb} differs from B=1")
        return "queries: B in 1, 2, 3, 6, 16, 19; query 0 bitwise at every B"
    if case == "ties":
        for tau in (2, 37, 500):
            u, it, thr, tab = k1_edge_inputs(torch, g, 300, 37, tau,
                                             ties=True)
            for nb in (1, 3, 16, 19):
                got = k1_exact(torch, ops, ref, u, it[:nb].contiguous(), thr,
                               tab, m, f"ties tau={tau} B={nb}")
                check(bool((got[1][:, :10] == m + 1).all())
                      and bool((got[0][:, 10:20] == 1.0).all()),
                      f"K1 ties tau={tau}: rows below/above the grid are "
                      "not at its edges")
        return "ties: runs of equal thresholds, scores on them, above and " \
               "below the grid"
    if case == "views":
        u, it, thr, tab = k1_edge_inputs(torch, g, 301, 37, 37)
        for nb in (1, 3, 16, 19):
            qs = it[:nb].contiguous()
            got = k1_exact(torch, ops, ref, u[1:], qs, thr[1:], tab[1:], m,
                           f"views B={nb}")
            want = ops.bound_ranks_batched(u[1:].clone(), qs,
                                           thr[1:].clone(), tab[1:].clone(),
                                           m=m)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"K1 views B={nb}: a view from row 1 differs from copies")
        return "views: users, thresholds and table from row 1"
    # K6: tile sizes 256 and 100, a tail tile past n, duplicate ids
    n = 1000
    u, it, thr, tab = k1_edge_inputs(torch, g, n, 37, 37)
    for bn in (256, 100):
        nblk = -(-n // bn)
        for nb in (1, 3, 16, 19):
            qs = it[:nb].contiguous()
            full = k1_exact(torch, ops, ref, u, qs, thr, tab, m,
                            f"K6 base B={nb}")
            for ids in ((nblk - 1, 0, 3, 3), (nblk - 1,), (2, 2, 1)):
                t = torch.tensor(ids, dtype=torch.int32, device=dev)
                got = ops.bound_ranks_batched_pruned(u, qs, thr, tab, t, m=m,
                                                     block_n=bn)
                want = ref.ref_bound_ranks_masked(u, qs, thr, tab, m, t, bn)
                ridx = pruning.row_indices(t, bn).long()
                past = ridx >= n
                for a, b, c in zip(got, full, want):
                    check(torch.equal(a[:, ~past], b[:, ridx[~past]]),
                          f"K6 bn={bn} B={nb} ids={ids}: kept rows differ "
                          "from K1's")
                    check(bool((a[:, past] == float(m + 2)).all()),
                          f"K6 bn={bn}: rows past n are not m + 2")
                check(torch.equal(got[0], want[0].T)
                      and torch.equal(got[1], want[1].T),
                      f"K6 bn={bn} B={nb} ids={ids}: bounds differ from the "
                      "plain version")
    return "k6: block_n 256 and 100, tail tile, duplicate ids"


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


def quant_launch(ops, parts, qs, qn, rt, out):
    """K4/K5 launched directly into `out` (3, n, B), ≤ 16 queries a
    launch as the wrapper does, with the caller's stored_parts `parts`
    and ‖q‖₁ `qn`; no checks, no allocation, no sync."""
    step = ops.user_scores.MAX_B
    for b0 in range(0, qs.shape[0], step):
        b1 = min(qs.shape[0], b0 + step)
        ops.user_scores.bound_ranks_quant_kernel_call(
            rt.spec_kind, *parts, qs[b0:b1], qn[b0:b1], rt,
            out[0, :, b0:b1], out[1, :, b0:b1], out[2, :, b0:b1])


def masked_launch(ops, users, qs, qn, rt, ids, block_n, out):
    """K6 (f32) or K7 launched directly into `out` (3, nk·block_n, B) over
    the already checked tile list `ids`, with the caller's ‖q‖₁ `qn`;
    the wrapper's range check of the ids syncs with the card, which
    would serialize a timing loop. At f32, ids None launches K1 over
    every row into `out` (3, n, B)."""
    step = ops.user_scores.MAX_B
    for b0 in range(0, qs.shape[0], step):
        b1 = min(qs.shape[0], b0 + step)
        o = (out[0, :, b0:b1], out[1, :, b0:b1], out[2, :, b0:b1])
        if rt.spec_kind == "f32":
            ops.user_scores.bound_ranks_batched_kernel_call(
                users, qs[b0:b1], rt.thresholds, rt.table, *o, m=rt.m,
                block_ids=ids, block_n=block_n)
        else:
            ops.user_scores.bound_ranks_quant_kernel_call(
                rt.spec_kind, *ops.stored_parts(users, rt.spec_kind),
                qs[b0:b1], qn[b0:b1], rt, *o, block_ids=ids,
                block_n=block_n)


def quant_launches(torch, ops, users, qs, qn, rt):
    """K4/K5 launched directly with the caller's ‖q‖₁ `qn` → (r_lo, r_up,
    est), each (n, B)."""
    parts = ops.stored_parts(users, rt.spec_kind)
    out = torch.empty((3, parts[0].shape[0], qs.shape[0]),
                      dtype=torch.float32, device=qs.device)
    quant_launch(ops, parts, qs.contiguous(), qn.contiguous(), rt, out)
    torch.cuda.synchronize()
    return out[0], out[1], out[2]


def netflix_data(torch, rt_mod, synthetic_embeddings, RankTableConfig, dev):
    """The main path's inputs: synthetic embeddings at Netflix size from
    seed 0, the build's sample positions and weights (seed 1), and B item
    queries (seed 2) led by QUERY_ITEM → (users, items, cfg, pos, w, qs)."""
    users, items = synthetic_embeddings(0, N, M, D, device=dev)
    cfg = RankTableConfig(tau=TAU, omega=OMEGA, s=S_PER)
    gb = torch.Generator(device=dev)
    gb.manual_seed(1)
    pos, w = rt_mod.stratified_sample_indices(M, cfg, gb)
    return users, items, cfg, pos, w, items[netflix_qids(torch, dev)] \
        .contiguous()


def netflix_qids(torch, dev):
    """The main path's B query item ids (seed 2), led by QUERY_ITEM."""
    gq = torch.Generator(device=dev)
    gq.manual_seed(2)
    qids = torch.randperm(M, generator=gq, device=dev)[:B]
    qids[0] = QUERY_ITEM
    return qids


def quant_digests(torch, ops, query_mod, tables, users, qs):
    """SHA-256 of the (r_lo, r_up, est) bytes of one K4/K5 launch and one
    K7 launch for each spec (tables: {spec: (stored users, rank table)}),
    stored and raw f32 rows, and B = 16 and 1; K7 over half the tiles of
    256 rows in a seeded order, then the tail tile and a duplicated
    first tile. Returns the lines to print."""
    import hashlib
    n, bn = users.shape[0], 256
    nblk = -(-n // bn)
    gen = torch.Generator()
    gen.manual_seed(5)
    ids = torch.cat([torch.randperm(nblk, generator=gen)[:nblk // 2],
                     torch.tensor([nblk - 1, 0, 0])]).to(
        device=qs.device, dtype=torch.int32)
    digest = lambda t: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
    lines = []
    for spec, (su, rt) in tables.items():
        kid = "K4" if spec == "bf16" else "K5"
        for what, u in (("stored", su), ("raw f32", users)):
            parts = ops.stored_parts(u, spec)
            for nb in (B, 1):
                q = qs[:nb].contiguous()
                qn = query_mod.query_l1(q)
                out = torch.empty((3, n, nb), dtype=torch.float32,
                                  device=qs.device)
                quant_launch(ops, parts, q, qn, rt, out)
                lines.append(f"  digest {kid} {spec} {what} B={nb}: "
                             f"{digest(out)}")
                out = torch.empty((3, ids.numel() * bn, nb),
                                  dtype=torch.float32, device=qs.device)
                masked_launch(ops, u, q, qn, rt, ids, bn, out)
                lines.append(f"  digest K7 {spec} {what} B={nb}, "
                             f"{ids.numel()} tiles: {digest(out)}")
                del out
    return lines


def step1_digest(got) -> str:
    """SHA-256 of a step-1 call's (r_lo, r_up, est), each (B, rows)."""
    import hashlib
    h = hashlib.sha256()
    for x in got:
        h.update(x.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def k1_digests(ops, users, qs, rt) -> list:
    """K1's output digests on the f32 Netflix engine, B = 16 and 1."""
    return [f"  digest K1 B={nb}: " + step1_digest(ops.bound_ranks_batched(
        users, qs[:nb].contiguous(), rt.thresholds, rt.table, m=rt.m))
        for nb in (B, 1)]


def kept_tiles(torch, np, pruning, eng_p, q):
    """The tiles the pruned engine `eng_p` launches its step 1 over for
    queries q: phase A's kept union, bucketed → (union, ids on the card)."""
    rt = eng_p.rank_table
    su = eng_p.users if eng_p.stored_users is None else eng_p.stored_users
    summ = eng_p._backend.summary_for(rt, su)
    bn = eng_p._backend.block_size
    keep, _ = pruning.phase_a(summ, q, k=K)
    union = np.flatnonzero(keep.cpu().numpy().any(axis=0))
    ids = pruning.bucket_blocks(union, n_blocks=summ.n_blocks,
                                min_blocks=-(-K // bn))
    return union, torch.from_numpy(ids).to(q.device)


def k6_digests(torch, np, ops, pruning, eng_p, qs) -> list:
    """K6's output digests over the f32 forced pruned engine's kept tiles
    (phase 4c (ii)), B = 16 and 1."""
    lines = []
    rt, bn = eng_p.rank_table, eng_p._backend.block_size
    for nb in (B, 1):
        q = qs[:nb].contiguous()
        _, ids = kept_tiles(torch, np, pruning, eng_p, q)
        got = ops.bound_ranks_batched_pruned(eng_p.users, q, rt.thresholds,
                                             rt.table, ids, m=rt.m,
                                             block_n=bn)
        lines.append(f"  digest K6 B={nb}, {ids.numel()} tiles: "
                     f"{step1_digest(got)}")
    return lines


def reordered_build(ReverseKRanksEngine, PrunedBackend, users, items, cfg,
                    pos, w, dev):
    """Phase 4c's f32 build: the main path's data k-means-reordered, on
    pruned:fused at the default cap."""
    return ReverseKRanksEngine.build(users, items, cfg, None,
                                     backend=PrunedBackend("fused"),
                                     device=dev, positions=pos, weights=w,
                                     cluster_reorder=True)


def quant_configs(ops):
    """One line per K4/K5/K7 instance of the main path's sizes: the
    launch its launcher makes and the kernel's resources."""
    lines = []
    for spec, kid in (("bf16", "K4"), ("int8", "K5")):
        for raw in (False, True):
            for nb in (B, 1):
                for masked in (False, True):
                    c = ops.user_scores.quant_launch_config(spec, raw, nb, D,
                                                            TAU, masked)
                    lines.append(
                        f"  {'K7 ' + spec if masked else kid} "
                        f"{'raw f32' if raw else 'stored'} B={nb}: tile "
                        f"{c['tile_rows']} rows, {c['stages']} stages"
                        + (", thresholds staged" if c["thresholds_staged"]
                           else "")
                        + f", {c['smem_bytes']} B dynamic + "
                        f"{c['static_smem_bytes']} B static shared memory, "
                        f"{c['blocks_per_sm']} blocks an SM, "
                        f"{c['registers']} registers and "
                        f"{c['local_bytes']} B local a thread")
    return lines


def k1_configs(ops, depths) -> list:
    """One line per K1/K6 launch at d = 200 (B = 16 and 1) and at phase
    3's depths (B = 16): the launch its launcher makes and the kernel's
    resources."""
    lines = []
    for d, nb in [(D, B), (D, 1)] + [(d, B) for d in depths]:
        for masked in (False, True):
            c = ops.user_scores.launch_config(nb, d, TAU, masked)
            lines.append(
                f"  {'K6' if masked else 'K1'} d={d} B={nb}: tile "
                f"{c['tile_rows']} rows, {c['stages']} stages"
                + (", thresholds staged" if c["thresholds_staged"] else "")
                + (f", rows in chunks of {c['row_chunk']}"
                   if c["row_chunk"] < d else "")
                + f", {c['smem_bytes']} B dynamic + "
                f"{c['static_smem_bytes']} B static shared memory, "
                f"{c['blocks_per_sm']} blocks an SM, {c['registers']} "
                f"registers and {c['local_bytes']} B local a thread")
    return lines


def k3_config_line(ops, d: int) -> str:
    """K3's launch at depth d and its kernel's resources."""
    c = ops.exact_rank.launch_config(d)
    return (f"  K3 d={d}: {c['block_users']} users x {c['tile_items']} "
            f"items a block, {c['stages']} stages of {c['stage_depth']} "
            f"depths, user tile "
            f"{'resident' if c['users_resident'] else 'staged'}, "
            f"{c['smem_bytes']} B dynamic shared memory, "
            f"{c['blocks_per_sm']} blocks an SM, {c['registers']} registers "
            f"and {c['local_bytes']} B local a thread")


def k2_config_line(ops, n: int, d: int, S: int) -> str:
    """K2's launches at (n, d, S) and their kernels' resources."""
    c = ops.table_build.launch_config(n, d, S)
    return (f"  K2 n={n} d={d} S={S}: product {c['block_users']} users x "
            f"{c['tile_samples']} samples a block, {c['stages']} stages of "
            f"{c['stage_depth']} depths, user tile "
            f"{'resident' if c['users_resident'] else 'staged'}, "
            f"{c['smem_bytes']} B dynamic shared memory, "
            f"{c['blocks_per_sm']} blocks an SM, {c['registers']} registers "
            f"and {c['local_bytes']} B local a thread; count "
            f"{c['count_users_per_block']} users (a warp each) a block, runs "
            f"of {c['count_run']} samples, {c['count_smem_bytes']} B dynamic "
            f"shared memory, {c['count_blocks_per_sm']} blocks an SM, "
            f"{c['count_registers']} registers and {c['count_local_bytes']} "
            f"B local a thread; {c['chunk_users']} users a chunk, workspace "
            f"{c['workspace_bytes']} B")


def k2_resident_cap(ops, S: int) -> int:
    """The last depth at which K2's product keeps its user tile
    resident."""
    return max(d for d in range(1, D_WIDE)
               if ops.table_build.launch_config(1, d, S)["users_resident"])


def table_digest(table) -> str:
    """SHA-256 of a rank table's f32 values (K2's output)."""
    import hashlib
    return hashlib.sha256(table.cpu().numpy().tobytes()).hexdigest()


def k3_edge_depths(ops) -> tuple:
    """The depths phase 3 drives K3 at: odd (d = 37), the last depth
    whose user tile stays resident, the next (staged), and d = 1,031."""
    cap = max(d for d in range(1, D_WIDE)
              if ops.exact_rank.launch_config(d)["users_resident"])
    return (37, cap, cap + 1, D_WIDE)


def offset_view(torch, x):
    """The values of x (n, d) in a contiguous view that starts 4 bytes past
    a 16-byte boundary: rows at any 4-byte address."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    return view


def k3_digest(truth, exact_idx, exact_rk) -> str:
    """SHA-256 of the K3 grading's outputs: the rank vectors, then each
    query's reverse_k_ranks (indices, ranks)."""
    import hashlib
    h = hashlib.sha256()
    for t in truth:
        h.update(t.cpu().numpy().tobytes())
    for i, r in zip(exact_idx, exact_rk):
        h.update(i.cpu().numpy().tobytes())
        h.update(r.cpu().numpy().tobytes())
    return h.hexdigest()


def grade(torch, exact_mod, users, items, qs):
    """The exact grading of phase 4: for each query its ranks and its
    reverse_k_ranks, two K3 launches → (ranks, indices, their ranks)."""
    truth, exact_idx, exact_rk = [], [], []
    for b in range(qs.shape[0]):
        idx, rk = exact_mod.reverse_k_ranks(users, items, qs[b], K)
        exact_idx.append(idx)
        exact_rk.append(rk)
        truth.append(exact_mod.exact_ranks(users, items, qs[b]))
    return truth, exact_idx, exact_rk


def row_views(rt, su):
    """rt and su with every per-user array a view from row 1 on (at an
    offset from its allocation), and contiguous copies of those views."""
    view = lambda t: None if t is None else t[1:]
    copy = lambda t: None if t is None else t[1:].clone()
    tables = [type(rt)(**{f: (rt.m if f == "m" else fn(getattr(rt, f)))
                          for f in rt._fields}) for fn in (view, copy)]
    users = [type(su)(*(fn(x) for x in su)) for fn in (view, copy)]
    return tables, users


def matmul_ms(torch, users, items, block: int = 32_768) -> float:
    """Device time of torch.matmul of users (n, d) by items.T in user
    blocks of `block` rows into one preallocated score buffer, summed
    over the blocks: the f32 product alone (TF32 off), as a yardstick."""
    buf = torch.empty((min(block, users.shape[0]), items.shape[0]),
                      dtype=torch.float32, device=users.device)
    it = items.T

    def run():
        for u0 in range(0, users.shape[0], block):
            u = users[u0:u0 + block]
            torch.matmul(u, it, out=buf[:u.shape[0]])
    ms = time_ms(torch, run, reps=3)
    del buf
    return ms


def device_breakdown(torch, fn, reps: int = 10, top: int = 5) -> str:
    """Where fn()'s device time goes, by torch.profiler over reps calls:
    the device time a call beside its CUDA-event time (their ratio is the
    device's busy share), then the top kernels by device time a call."""
    from torch.profiler import ProfilerActivity, profile
    wall = time_ms(torch, fn, reps=reps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    rows = sorted(((dev_us(e) / reps / 1e3, e.key) for e in
                   prof.key_averages()
                   if dev_us(e) > 0 and not e.key.startswith("aten::")),
                  reverse=True)
    check(bool(rows), "torch.profiler recorded no device time")
    busy = sum(ms for ms, _ in rows)
    head = "; ".join(f"{name[:48]} {ms:.3f} ms" for ms, name in rows[:top])
    return (f"device {busy:.3f} ms a call of {wall:.3f} ms (busy "
            f"{100 * busy / wall:.1f}%); {head}")


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


def check_quant(torch, ops, ref, Q, users, qs, rt, label, got=None):
    """K4/K5 against the plain version under the bracketing rule (module
    docstring); `got` as in check_k1 (K7's kept rows). Returns (max abs
    err over all cells, cells that differ)."""
    rows, uscale, uslack = ops.stored_parts(users, rt.spec_kind)
    if got is None:
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
    every (query, user), and of its order statistics, to 1e-4; a user
    that reads +inf (deleted) must read it in both."""
    fin = torch.isfinite(want.r_lo) & torch.isfinite(want.r_up)
    over_lo = (res.r_lo - want.r_lo)[fin]     # must be <= 1e-4
    under_up = (want.r_up - res.r_up)[fin]    # must be <= 1e-4
    n_bad = (int((over_lo > 1e-4).sum()) + int((under_up > 1e-4).sum())
             + int((~fin & (torch.isfinite(res.r_lo)
                            | torch.isfinite(res.r_up))).sum()))
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


def same_selection(torch, got, want, label):
    """A pruned result against the full scan's on the same engine: the
    indices, their est, R↓_k, R↑_k and the guarantee, bitwise."""
    for f in ("indices", "est_rank", "R_lo_k", "R_up_k", "guaranteed"):
        check(torch.equal(getattr(got, f), getattr(want, f)),
              f"{label}: {f} differs from the full scan's")


def step1_need(torch, Q, ops, users, q, rt):
    """Least input bytes and operations of K1's (f32), K4's (bf16) or
    K5's (int8) function on these rows (raw f32 users at f32, stored
    users otherwise): the rows and per-row vectors once, Q and ‖q‖₁ once,
    per row a sector-level search of the thresholds row per query (none
    at int8), and the distinct table sectors that this run's lookups
    read. Outputs are the caller's to add."""
    kind = rt.spec_kind
    n, d = (users.rows if kind != "f32" else users).shape
    nb, tau = q.shape[0], rt.tau
    if kind == "f32":
        idx = Q._bucketize(rt.thresholds, users @ q.T)
        return (4 * (n * d + nb * d) + n * search_bytes(4 * tau, nb)
                + gather_bytes(torch, idx, tau, 4),
                2 * n * d * nb + n * nb * math.ceil(math.log2(tau)))
    rows, uscale, uslack = ops.stored_parts(users, kind)
    qn = Q.query_l1(q)
    indices = {"bf16": Q.bf16_indices, "int8": Q.int8_indices}[kind]
    idx_lo, idx_hi = indices(rt, Q._dequant_matmul(rows, uscale, q),
                             uslack * qn[None, :])
    if kind == "bf16":
        need = (2 * n * d + 4 * n + n * search_bytes(2 * tau, nb)
                + gather_bytes(torch, idx_hi, tau, 2, idx_lo))
        flops = 2 * n * d * nb + 2 * n * nb * math.ceil(math.log2(tau))
    else:
        need = n * d + 28 * n + gather_bytes(torch, idx_hi, tau, 1, idx_lo)
        flops = 2 * n * d * nb + 20 * n * nb
    return need + 4 * (nb * d + nb), flops


# ------------------------------------------------------ the mutable index
BUILD_SEED = 11                    # phase 4d's builds draw their samples
# phase 4d's churn at Netflix size: insert, delete, upsert, append and
# delete users; the correction's widths are then 128 and 64
CHURN = dict(n_insert=96, n_delete=64, n_upsert=32, n_append=32, n_dead=48)


class Churn:
    """Phase 4d's mutation script over n users and m base items: insert
    the held-out items, delete base items (never a query item), upsert
    users, append users, delete users (two of them appended)."""

    def __init__(self, torch, g, n, m, new_items, up_vecs, app_vecs,
                 n_delete, n_dead, keep_items):
        dev = new_items.device
        free = torch.ones(m, dtype=torch.bool, device=dev)
        free[keep_items.to(dev)] = False
        cand = torch.nonzero(free).flatten()
        self.new_items = new_items
        self.delete_ids = sorted(cand[torch.randperm(
            cand.numel(), generator=g, device=dev)[:n_delete]].tolist())
        perm = torch.randperm(n, generator=g, device=dev).tolist()
        self.upsert_idx = sorted(perm[:up_vecs.shape[0]])
        self.up_vecs = up_vecs
        self.app_vecs = app_vecs
        n_app = app_vecs.shape[0]
        self.dead_idx = sorted(perm[up_vecs.shape[0]:up_vecs.shape[0]
                                    + n_dead - min(2, n_app)]
                               + list(range(n, n + min(2, n_app))))

    def apply(self, torch, ops, eng, times=None, peaks=None):
        """Run the script on `eng`; each upsert must launch K2 once on the
        card. `times` collects the host-clock time of each call, `peaks`
        (on the card) the peak of allocated device memory during each
        call above what was allocated before it."""
        on_card = eng.users.is_cuda
        sync = torch.cuda.synchronize if on_card else (lambda: None)
        steps = (("insert_items", lambda: eng.insert_items(self.new_items)),
                 ("delete_items", lambda: eng.delete_items(self.delete_ids)),
                 ("upsert_users", lambda: eng.upsert_users(
                     self.up_vecs, indices=self.upsert_idx)),
                 ("upsert_users (append)",
                  lambda: eng.upsert_users(self.app_vecs)),
                 ("delete_users", lambda: eng.delete_users(self.dead_idx)))
        for name, fn in steps:
            k2 = ops.LAUNCHES["k2_table_build"]
            sync()
            if on_card and peaks is not None:
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            fn()
            sync()
            if times is not None:
                times[name] = time.perf_counter() - t0
            if on_card and peaks is not None:
                peaks[name] = torch.cuda.max_memory_allocated() - held
            if on_card and name.startswith("upsert"):
                check(ops.LAUNCHES["k2_table_build"] == k2 + 1,
                      f"{name} did not launch K2 once")


def delta_data(torch, synthetic_embeddings, dev, n, m, d, n_insert, n_delete,
               n_upsert, n_append, n_dead, nq, avoid=None):
    """Phase 4d's inputs from one synthetic draw (seed 0) of n + upserted +
    appended users and m + n_insert items: the base users and items,
    the held-out items to insert and the user vectors to upsert and
    append; nq live base items as queries (seed 3) and the first
    inserted item as the single query; the mutation script, which
    deletes no query item (nor an item id of `avoid`)."""
    users_all, items_all = synthetic_embeddings(
        0, n + n_upsert + n_append, m + n_insert, d, device=dev)
    users = users_all[:n].contiguous()
    items = items_all[:m].contiguous()
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    qids = torch.randperm(m, generator=g, device=dev)[:nq]
    keep = qids if avoid is None else torch.cat([qids, avoid.to(dev)])
    churn = Churn(torch, g, n, m, items_all[m:].contiguous(),
                  users_all[n:n + n_upsert].contiguous(),
                  users_all[n + n_upsert:].contiguous(), n_delete, n_dead,
                  keep)
    return users, items, items[qids].contiguous(), \
        items_all[m:m + 1].contiguous(), churn


def fused_delta_bounds(torch, ops, query_mod, rt_mod, snap, qs):
    """The fused backend's corrected (r_lo, r_up, est), each (B, n): K1/
    K4/K5, then the correction on u·q, as `QueryBackend._delta_query`."""
    users, rt, corr = snap.query_users(), snap.rank_table, snap.corr
    r = ops.bound_ranks_batched_stored(users, qs, rt)
    scores, slack = query_mod.user_scores_batch(users, qs)
    out = rt_mod.apply_delta_corrections(scores, r[0].T, r[1].T, r[2].T,
                                         corr, slack=slack)
    return tuple(x.T for x in out)


def brute_force_shift(torch, snap, qs, block=8192):
    """#{a ∈ A : u·a > u·q} − #{p ∈ D : u·p > u·q} per (query, user),
    (B, n) f32, from the products the engine takes: U·qᵀ and U·Aᵀ, U·Dᵀ
    whole (their shapes fix their bits), compared in blocks of users."""
    users = snap.users
    scores = users @ qs.T
    base, delta = snap.base, snap.delta
    dead = torch.from_numpy(~delta.base_live).to(users.device)
    shift = torch.zeros(scores.shape, dtype=torch.float32,
                        device=users.device)
    for vecs, sign in ((delta.added_items, 1.0), (base.items[dead], -1.0)):
        prod = users @ vecs.T
        for u0 in range(0, users.shape[0], block):
            s = scores[u0:u0 + block]
            cnt = (prod[u0:u0 + block, :, None] > s[:, None, :]).sum(1)
            shift[u0:u0 + block] += sign * cnt.to(torch.float32)
    return shift.T


def delta_digest(torch, dev, ReverseKRanksEngine, RankTableConfig,
                 synthetic_embeddings, ops, query_mod, rt_mod) -> str:
    """The digest of phase 4d's f32 fused delta bounds (B = 16), computed
    by the imported package on the same inputs (`--digests`)."""
    users, items, qs, _, churn = delta_data(
        torch, synthetic_embeddings, dev, N, M, D, *CHURN.values(), B,
        netflix_qids(torch, dev))
    eng = ReverseKRanksEngine.build(
        users, items, RankTableConfig(tau=TAU, omega=OMEGA, s=S_PER),
        BUILD_SEED, backend="fused", device=dev)
    churn.apply(torch, ops, eng)
    return step1_digest(fused_delta_bounds(torch, ops, query_mod, rt_mod,
                                           eng.current_snapshot(), qs))


def mutable_index_checks(dev, *, n=N, m=M, d=D, tau=TAU,
                         n_insert=CHURN["n_insert"],
                         n_delete=CHURN["n_delete"],
                         n_upsert=CHURN["n_upsert"],
                         n_append=CHURN["n_append"], n_dead=CHURN["n_dead"],
                         timing=True, pruned=None, avoid=None):
    """Phase 4d: the mutable index on the card (or, for a rehearsal, the
    CPU). Builds f32, bf16 and int8 fused engines over phase 4d's data
    (`delta_data`) with seed BUILD_SEED, runs the churn on them and on
    the engines of `pruned` ((label, mutable engine over n users and m
    items, queries) triples, whose query items are in `avoid`; by
    default the same data reordered), and checks, each fatally:

      (a) the f32 fused delta bounds = clip(static + brute-force shift,
          1, m' + 1) on every live row, dead rows +inf;
      (b) bf16 and int8 delta bounds contain the f32 ones (1e-4);
      (c) fused delta selects as dense delta (`selections_agree`);
      (d) pruned:fused and pruned:dense select bitwise the inner delta
          full scan, on every engine of `pruned`;
      (e) insert → delete → rebuild() is a scratch build with the same
          seed over live_items(), table bitwise, selections bitwise;
      (f) upserted and appended rows within the reference's tolerance of
          a scratch build over the modified users, the others bitwise;
      (g) (on the card) each step launched exactly its kernels, counted
          in a window of its own that holds no direct wrapper call of
          the checks: the churn K2 once an upsert and nothing else; the
          engines' delta queries K1 (f32, B = 16 and 1), K4 (bf16) and
          K5 (int8) once each; each pruned:fused delta query K6 or K7
          once, each pruned:dense one nothing; grading K3 2·B times.

    Returns a report: the checks passed, the digest of the f32 fused
    delta bounds, and the numbers printed."""
    import torch
    from repro_torch.core import exact as exact_mod
    from repro_torch.core import metrics
    from repro_torch.core import query as query_mod
    from repro_torch.core import rank_table as rt_mod
    from repro_torch.core.backends import PrunedBackend, get_backend
    from repro_torch.core.engine import ReverseKRanksEngine
    from repro_torch.core.types import RankTableConfig
    from repro_torch.data.pipeline import synthetic_embeddings
    from repro_torch.kernels import ops
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    report = {"checks": []}
    users, items, qs, q1, churn = delta_data(
        torch, synthetic_embeddings, dev, n, m, d, n_insert, n_delete,
        n_upsert, n_append, n_dead, B, avoid)
    cfgs = {spec: RankTableConfig(tau=tau, omega=OMEGA, s=S_PER,
                                  storage_dtype=spec)
            for spec in ("f32", "bf16", "int8")}
    engines = {spec: ReverseKRanksEngine.build(
        users, items, cfg, BUILD_SEED, backend="fused", device=dev)
        for spec, cfg in cfgs.items()}
    eng = engines["f32"]
    if pruned is None:
        pruned = []
        for spec, cfg in cfgs.items():
            pruned.append((f"{spec}, reordered", ReverseKRanksEngine.build(
                users, items, cfg, BUILD_SEED, backend="fused", device=dev,
                cluster_reorder=True), qs))
    static = {}
    if timing:
        static["qb"] = time_ms(torch, lambda: eng.query_batch(qs, K, C),
                               reps=10)
        static["q1"] = time_ms(torch, lambda: eng.query(q1[0], K, C),
                               reps=10)
        static["qb_prof"] = device_breakdown(
            torch, lambda: eng.query_batch(qs, K, C))
        static["q1_prof"] = device_breakdown(
            torch, lambda: eng.query(q1[0], K, C))
        static["mem"] = eng.memory_bytes()

    # (g): each step of the path counts its launches in a window of its
    # own, zeroed just before and read just after; the checks' own
    # wrapper calls fall outside every window
    windows = {}

    def expect(label, want):
        got = {k: v for k, v in ops.LAUNCHES.items() if v}
        windows[label] = got
        if on_card:
            check(got == {k: v for k, v in want.items() if v},
                  f"(g) {label}: launches {got}, expected {want}")

    per_block = lambda nq: -(-nq // ops.user_scores.MAX_B)
    masked = {"f32": "k6_bound_ranks_masked",
              "bf16": "k7_bound_ranks_bf16_masked",
              "int8": "k7_bound_ranks_int8_masked"}

    # the churn: the bf16 engine's is the process's first, so its calls
    # also load their kernels (CUDA loads a kernel's module at its first
    # launch); the f32 engine's, after the int8 one's, is timed warm,
    # with the peak of device memory each of its calls allocates
    ops.reset_launch_counts()
    times = {"first": {}, "warm": {}}
    peaks = {}
    for spec in ("bf16", "int8", "f32"):
        churn.apply(torch, ops, engines[spec], {
            "bf16": times["first"], "f32": times["warm"]}.get(spec),
            peaks if spec == "f32" else None)
    for _, e, _ in pruned:
        churn.apply(torch, ops, e)
    expect(f"churn of {len(engines) + len(pruned)} engines",
           {"k2_table_build": 2 * (len(engines) + len(pruned))})
    snap = eng.current_snapshot()
    corr = snap.corr
    m_new = corr.m_new
    print(f"  churn: +{churn.new_items.shape[0]} items, "
          f"-{len(churn.delete_ids)} base items, {len(churn.upsert_idx)} "
          f"users upserted, {churn.app_vecs.shape[0]} appended, "
          f"{len(churn.dead_idx)} deleted; {eng.delta_stats()}; correction "
          f"widths {corr.n_add} + {corr.n_del}, selection m "
          f"{corr.selection_m()}, epoch {eng.epoch}")
    check(eng.epoch == 5 and m_new == m + n_insert - n_delete
          and eng.n == n + n_append, "the churn did not publish as expected")
    ops.reset_launch_counts()
    res = {spec: e.query_batch(qs, K, C) for spec, e in engines.items()}
    res1 = eng.query(q1[0], K, C)
    expect(f"delta query_batch(B={B}) at f32, bf16, int8 and query at f32",
           {"k1_bound_ranks": per_block(B) + 1,
            "k4_bound_ranks_bf16": per_block(B),
            "k5_bound_ranks_int8": per_block(B),
            "select_kth": 4, "select_lemma1": 4})
    live = torch.from_numpy(snap.delta.user_live).to(dev)

    # (a) the f32 fused delta bounds against the brute force, B = 16 and
    # the inserted item alone
    rt = snap.rank_table
    top = float(m_new) + 1.0
    moved = 0
    for q, got in ((qs, res["f32"]), (q1, res1)):
        st_lo, st_up, _ = ops.bound_ranks_batched(snap.users, q,
                                                  rt.thresholds, rt.table,
                                                  m=rt.m)
        shift = brute_force_shift(torch, snap, q)
        want_lo = torch.clamp(st_lo + shift, 1.0, top)[:, live]
        want_up = torch.clamp(st_up + shift, 1.0, top)[:, live]
        g_lo, g_up = got.r_lo.reshape(q.shape[0], -1), \
            got.r_up.reshape(q.shape[0], -1)
        check(torch.equal(g_lo[:, live], want_lo)
              and torch.equal(g_up[:, live], want_up),
              f"(a) f32 delta bounds at B={q.shape[0]} are not static + "
              "the brute-force shift")
        check(bool(torch.isinf(g_lo[:, ~live]).all())
              and bool(torch.isinf(g_up[:, ~live]).all()),
              "(a) a deleted user's bounds are not +inf")
        moved += int((shift[:, live] != 0).sum())
    r = res["f32"]
    print(f"  (a) f32 fused delta bounds = clip(K1 static + brute-force "
          f"count shift, 1, m'+1) on all {int(live.sum())} live rows x "
          f"({B} queries + the inserted item alone) ({moved} cells "
          "shifted), dead rows +inf: checked")
    report["checks"].append("a")

    # (b) containment of the quantized delta bounds
    for spec in ("bf16", "int8"):
        check_containment(torch, res[spec], r, f"{spec} delta vs f32 delta")
        check(bool(torch.isinf(res[spec].r_lo[:, ~live]).all()),
              f"(b) {spec}: a deleted user's bounds are not +inf")
    report["checks"].append("b")

    # (c) fused delta against dense delta
    for spec, e in engines.items():
        s = e.current_snapshot()
        f_b = fused_delta_bounds(torch, ops, query_mod, rt_mod, s, qs)
        d_b = query_mod._delta_bounds_batch(s.rank_table, s.query_users(),
                                            qs, s.corr)
        dense = get_backend("dense").query_batch(
            s.rank_table, s.query_users(), qs, k=K, c=C, delta=s.corr)
        n_diff, tol = selections_agree(torch, query_mod, res[spec], dense,
                                       f_b, d_b, K, C,
                                       s.corr.selection_m())
        print(f"  (c) {spec} fused delta vs dense delta: {n_diff} users "
              f"selected by one backend only, all explained (est "
              f"tolerance {tol:.3g})")
        del f_b, d_b
    report["checks"].append("c")
    report["digest"] = step1_digest(fused_delta_bounds(
        torch, ops, query_mod, rt_mod, snap, qs))

    # (d) pruned delta against the inner delta full scan, B = 16 and 1
    for label, e, q in pruned:
        s = e.current_snapshot()
        for inner in ("fused", "dense"):
            pb = PrunedBackend(inner, max_union_frac=1.0)
            stats = []
            for qb in (q, q[:1]):
                ops.reset_launch_counts()
                got = pb.query_batch(s.rank_table, s.query_users(), qb, k=K,
                                     c=C, delta=s.corr)
                expect(f"{label} pruned:{inner} B={qb.shape[0]}",
                       {masked[s.rank_table.spec_kind]: per_block(
                           qb.shape[0])} if inner == "fused" else {})
                full = get_backend(inner).query_batch(
                    s.rank_table, s.query_users(), qb, k=K, c=C,
                    delta=s.corr)
                stats.append(pb.stats)
                check(pb.stats.fallback == "",
                      f"(d) {label} pruned:{inner} fell back")
                same_selection(torch, got, full,
                               f"(d) {label} pruned:{inner} B={qb.shape[0]}")
            print(f"  (d) {label} pruned:{inner} delta: kept union "
                  f"{stats[0].kept_union} of {stats[0].n_blocks}, skip rate "
                  f"{stats[0].skip_rate:.4f} (B={B}), "
                  f"{stats[1].skip_rate:.4f} (B=1); indices, est, R_k "
                  f"bitwise the {inner} delta full scan's at both")
    report["checks"].append("d")

    # grading over the live users and items (K3)
    users_live = snap.users[live].contiguous()
    items_live = eng.live_items()
    sync()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    truth, exact_idx, _ = grade(torch, exact_mod, users_live, items_live, qs)
    sync()
    grade_s = time.perf_counter() - t0
    expect(f"grading B={B} queries", {"k3_exact_ranks": 2 * B})
    print("  (g) launches of each step of the delta path, each counted "
          "alone:")
    for label, got in windows.items():
        print(f"    {label}: {got}")
    if on_card:
        report["checks"].append("g")
    row_of = torch.cumsum(live.to(torch.int64), 0) - 1

    def accuracy(result):
        a, o = [], []
        for b in range(qs.shape[0]):
            idx = row_of[result.indices[b]].cpu().numpy()
            tr, ex = truth[b].cpu().numpy(), exact_idx[b].cpu().numpy()
            a.append(metrics.accuracy(idx, ex, tr, C))
            o.append(metrics.overall_ratio(idx, ex, tr))
        return sum(a) / len(a), sum(o) / len(o)

    acc_delta = accuracy(r)
    delta_q = {}
    if timing:
        delta_q["qb"] = time_ms(torch, lambda: eng.query_batch(qs, K, C),
                                reps=10)
        delta_q["q1"] = time_ms(torch, lambda: eng.query(q1[0], K, C),
                                reps=10)
        delta_q["qb_prof"] = device_breakdown(
            torch, lambda: eng.query_batch(qs, K, C))
        delta_q["q1_prof"] = device_breakdown(
            torch, lambda: eng.query(q1[0], K, C))
        delta_q["overhead"] = eng.correction_overhead()
        delta_q["mem"] = {spec: e.memory_bytes()
                          for spec, e in engines.items()}

    # (f) upserted rows against a scratch build over the modified users
    scratch = ReverseKRanksEngine.build(snap.users, items, cfgs["f32"],
                                        BUILD_SEED, backend="fused",
                                        device=dev)
    got_t, want_t = snap.rank_table, scratch.rank_table
    touched = torch.tensor(churn.upsert_idx + list(range(n, n + n_append)),
                           device=dev)
    others = torch.ones(got_t.n, dtype=torch.bool, device=dev)
    others[touched] = False
    for f in ("thresholds", "table"):
        a, b_ = getattr(got_t, f), getattr(want_t, f)
        check(torch.equal(a[others], b_[others]),
              f"(f) untouched {f} rows differ from the scratch build")
        a, b_ = a[touched], b_[touched]
        atol = 1e-6 if f == "thresholds" else 0.0
        check(bool((a - b_).abs().le(atol + 1e-6 * b_.abs()).all()),
              f"(f) upserted {f} rows beyond rtol 1e-6 of the scratch "
              "build")
    same_rows = int((got_t.table[touched] == want_t.table[touched]).all(
        1).logical_and((got_t.thresholds[touched]
                        == want_t.thresholds[touched]).all(1)).sum())
    print(f"  (f) upserted and appended rows within rtol 1e-6 of a scratch "
          f"build over the modified users ({same_rows} of "
          f"{touched.numel()} bitwise); the other {int(others.sum())} rows "
          "bitwise")
    report["checks"].append("f")
    del scratch

    # (e) rebuild against a scratch build over the live items
    sync()
    t0 = time.perf_counter()
    rec = eng.rebuild()
    sync()
    rebuild_s = time.perf_counter() - t0
    after = eng.current_snapshot()
    check(rec is not None and after.corr is not None
          and after.corr.n_add == 0 and after.corr.n_del == 0
          and after.rank_table.m == m_new,
          "(e) the rebuild did not drain the item delta")
    scratch = ReverseKRanksEngine.build(snap.users, items_live, cfgs["f32"],
                                        BUILD_SEED, backend="fused",
                                        device=dev)
    for f in ("thresholds", "table"):
        check(torch.equal(getattr(after.rank_table, f),
                          getattr(scratch.rank_table, f)),
              f"(e) rebuilt {f} differ from a scratch build")
    scratch.delete_users(churn.dead_idx)
    res_rb = eng.query_batch(qs, K, C)
    same_selection(torch, res_rb, scratch.query_batch(qs, K, C),
                   "(e) rebuilt engine vs scratch build")
    acc_rebuilt = accuracy(res_rb)
    print(f"  (e) rebuild {rebuild_s:.3f} s (host clock; {rec.build_s:.3f} "
          f"s build, {rec.swap_s:.4f} s swap): table bitwise a scratch build"
          f" with seed {BUILD_SEED} over the {items_live.shape[0]} live "
          "items; selections bitwise")
    report["checks"].append("e")
    report["checks"].sort()
    print(f"  §5 over the live users and items (K3, {2 * B} launches, "
          f"{grade_s:.2f} s): mutated f32 fused accuracy {acc_delta[0]:.4f} "
          f"overall ratio {acc_delta[1]:.4f}; rebuilt accuracy "
          f"{acc_rebuilt[0]:.4f} overall ratio {acc_rebuilt[1]:.4f}")
    check(res1.indices.shape == (K,), "query(q) of an inserted item")
    if timing:
        for when, label in (("first", "first calls (bf16 engine)"),
                            ("warm", "warm (f32 engine)")):
            print(f"  host clock of each mutation call (synced), {label}: "
                  + "; ".join(f"{k} {v * 1e3:.2f} ms"
                              for k, v in times[when].items()))
        print("  peak device memory each f32 mutation call allocated above "
              "what was held before it: " + "; ".join(
                  f"{k} {v / 2**20:.1f} MiB" for k, v in peaks.items()))
        print(f"  f32 fused query_batch(B={B}) static {static['qb']:.3f} ms, "
              f"delta {delta_q['qb']:.3f} ms; query static "
              f"{static['q1']:.3f} ms, delta {delta_q['q1']:.3f} ms; "
              f"correction_overhead() {delta_q['overhead']:.4f}")
        print(f"  profile static query_batch: {static['qb_prof']}")
        print(f"  profile delta query_batch: {delta_q['qb_prof']}")
        print(f"  profile static query: {static['q1_prof']}")
        print(f"  profile delta query: {delta_q['q1_prof']}")
        print(f"  memory_bytes static f32 {static['mem']}; with the "
              "correction " + ", ".join(
                  f"{k} {v}" for k, v in delta_q["mem"].items()))
    report.update(static=static, delta=delta_q, times=times, peaks=peaks,
                  launches=windows,
                  rebuild_s=rebuild_s, accuracy=(acc_delta, acc_rebuilt))
    return report


# ------------------------------------------------------------- serving
SWEEP = (450_000, 470_000, N)      # phase 6's n sweep, one capacity bucket
SERVE_Q, SERVE_THREADS = 512, 4    # phase 6's MicroBatcher load
C_ODD = 1.3                        # a c that is not a power of two
ELASTIC_REPLACES = "src/repro/kernels/ops.py:292"   # bound_ranks_tile
ELASTIC_KERNEL = {"f32": "k1_bound_ranks_elastic",
                  "bf16": "k4_bound_ranks_bf16_elastic",
                  "int8": "k5_bound_ranks_int8_elastic"}


def differing_fields(torch, got, want) -> list:
    """Names of the QueryResult fields that are not bitwise equal."""
    return [f for f, x, y in zip(type(want)._fields, got, want)
            if x.shape != y.shape or not torch.equal(x.to(y.device), y)]


def same_result(torch, got, want, label):
    bad = differing_fields(torch, got, want)
    check(not bad, f"{label}: fields {bad} differ")


def rows_view(users, rt, n):
    """The first n rows of either user representation and of the table,
    as views (contiguous, at offset 0)."""
    from repro_torch.core.types import RankTable, StoredUsers
    if isinstance(users, StoredUsers):
        users = StoredUsers(*(None if x is None else x[:n] for x in users))
    else:
        users = users[:n]
    return users, RankTable(m=rt.m, **{
        f: None if getattr(rt, f) is None else getattr(rt, f)[:n]
        for f in RankTable._fields if f != "m"})


def elastic_entry_checks(dev, *, n=1000, d=37, tau=37, m=777):
    """Phase 3: the elastic entries of K1, K4 and K5 (operands padded to
    the capacity of n rows, the row count read on the device), at every
    kind, B in 1, 16 and 19, and n_valid in {1, T - 1, T + 1, n,
    capacity}, T the kernel's tile rows, on integer inputs: rows below
    n_valid bitwise the existing entry's over the first n_valid rows and
    r_lo/r_up bitwise the plain version's (est within 1e-5 relative, the
    rule of every plain-version check on integer inputs); rows at or
    past n_valid not written (launched directly into NaN-filled
    outputs). Returns the lines to print."""
    import torch
    from repro_torch.core import elastic
    from repro_torch.core import query as query_mod
    from repro_torch.core import rank_table as rt_mod
    from repro_torch.core.types import RankTable, RankTableConfig
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device=dev)
    g.manual_seed(25)
    cap = elastic.capacity_for(n, elastic.default_tile())
    users, items, thr, tab = k1_edge_inputs(torch, g, cap, d, tau, m=m)
    cases = [("f32", users, RankTable(thr, tab, m))]
    for spec in ("bf16", "int8"):
        cfg = RankTableConfig(tau=tau, omega=4, s=16, storage_dtype=spec)
        cases.append((spec, cfg.storage.pack_users(users),
                      rt_mod.build_rank_table(users, items, cfg, g)))
    lines = []
    for kind, u, rt in cases:
        for nb in (1, 16, 19):
            qs = items[torch.arange(nb, device=dev) * 5 % m].contiguous()
            q16 = qs[:ops.user_scores.MAX_B]
            if kind == "f32":
                T = ops.user_scores.launch_config(
                    q16.shape[0], d, tau)["tile_rows"]
            else:
                T = ops.user_scores.quant_launch_config(
                    kind, False, q16.shape[0], d, tau)["tile_rows"]
            for nv in sorted({1, T - 1, T + 1, n, cap}):
                label = f"{kind} elastic B={nb} n_valid={nv} of {cap}"
                nvt = torch.tensor([nv], dtype=torch.int32, device=dev)
                got = ops.bound_ranks_batched_stored(u, qs, rt, nvt)
                u_n, rt_n = rows_view(u, rt, nv)
                full = ops.bound_ranks_batched_stored(u_n, qs, rt_n)
                torch.cuda.synchronize()
                for a, b in zip(got, full):
                    check(torch.equal(a[:, :nv], b),
                          f"{label}: rows below n_valid differ from the "
                          "existing entry's")
                if kind == "f32":
                    want = ref.ref_bound_ranks(users, qs, thr, tab, m)
                else:
                    rows, usc, usl = ops.stored_parts(u, kind)
                    want = ref.ref_bound_ranks_stored(
                        rows, usc, usl, qs, query_mod.query_l1(qs), rt)
                want = [x.T[:, :nv] for x in want]
                check(torch.equal(got[0][:, :nv], want[0])
                      and torch.equal(got[1][:, :nv], want[1]),
                      f"{label}: bounds differ from the plain version")
                err = (got[2][:, :nv] - want[2]).abs()
                check(bool((err <= 1e-5 * want[2].abs()).all()),
                      f"{label}: est beyond 1e-5 relative")
                # rows at or past n_valid are left unwritten
                out = torch.full((3, cap, q16.shape[0]), float("nan"),
                                 device=dev)
                if kind == "f32":
                    ops.user_scores.bound_ranks_batched_kernel_call(
                        users, q16, thr, tab, *out, m=m, n_valid=nvt)
                else:
                    ops.user_scores.bound_ranks_quant_kernel_call(
                        kind, *ops.stored_parts(u, kind), q16,
                        query_mod.query_l1(q16), rt, *out, n_valid=nvt)
                torch.cuda.synchronize()
                check(bool(torch.isnan(out[:, nv:]).all())
                      and not bool(torch.isnan(out[:, :nv]).any()),
                      f"{label}: the entry wrote rows at or past n_valid, "
                      "or left rows below it unwritten")
        lines.append(f"  {kind} elastic entry: n={n} of capacity {cap}, "
                     f"d={d} tau={tau}, B in 1, 16, 19, n_valid in 1, "
                     f"T - 1, T + 1, n, capacity: rows below n_valid "
                     f"bitwise the existing entry and the plain version's "
                     f"bounds, est within 1e-5, rows past it unwritten")
    return lines


def serving_checks(dev, *, users, items, cfg, pos, w, qs, engines,
                   sweep=SWEEP, n_serve=SERVE_Q, timing=True):
    """Phase 6: the serving path at the engines' size. `engines` maps
    "f32", "bf16" and "int8" to fused engines over `users` and `items`
    built with the samples (pos, w); qs (B, d) item queries. Each check
    is fatal:

      (a) elastic:fused at every spec is bitwise the fused engine in
          query_batch and query, at c = 2.0 and 1.3 (every field); on
          the card each program's first run, in a launch window of its
          own, launches its elastic entry exactly twice a 16 queries
          (one eager run, the capture), its replays none, and the
          program counts its replays; torch.profiler sees the kernel run
          inside 3 replays;
      (b) elastic:dense at f32 against dense by the explained-mismatch
          rule (its product runs over the capacity), its bounds bitwise
          the same plain computation outside the graph;
      (c) no new program (elastic_trace_count) across an n sweep inside
          one bucket, a change of c, item churn on the delta path, user
          appends and a rebuild that grows n; exactly one more for an n
          in a new bucket; a replay's bounds bitwise a direct call of
          the elastic entry; on the delta path after the item churn and
          after the append, elastic:fused against fused on the same
          snapshot, bitwise or by the explained-mismatch rule;
      (d) MicroBatcher on elastic:fused at f32, max_batch 16, pipeline
          depth 1 and 2, n_serve item queries from 4 client threads:
          every result held and bitwise its row of a synchronous
          query_batch of 16-wide blocks; no program built after warm-up;
          in each burst's launch window no wrapper launch, and one
          replay a tick;
      (e) on cached:elastic:fused, repeated queries resolve at admission,
          bitwise;
      (f) an injected serve.transfer fault fails exactly that tick's
          futures, and the next tick serves;
      (g) close(drain_s=...) with ticks in flight leaves no future
          unresolved.

    Returns a report: the checks passed, the elastic backends (for the
    kernel rows), (a)'s launch windows and the numbers printed."""
    import threading
    import numpy as np
    import torch
    from concurrent.futures import wait as wait_futures
    from repro_torch.core import elastic
    from repro_torch.core import query as query_mod
    from repro_torch.core import rank_table as rt_mod
    from repro_torch.core.backends import FusedBackend
    from repro_torch.core.engine import ReverseKRanksEngine
    from repro_torch.kernels import ops, ref
    from repro_torch.serve import MicroBatcher, SchedulerClosed, faults
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    report = {"checks": [], "backends": {}}
    n, m = users.shape[0], engines["f32"].rank_table.m
    q1 = qs[0]

    # (a) elastic:fused bitwise fused, every spec, two c. The first run
    # of each program is where the main path launches its kernel: one
    # eager run and the capture, ⌈B/16⌉ launches each, counted in a window
    # of its own; the replays that follow call no wrapper, so the window
    # holds exactly those, and each program reports its replays and the
    # launches its graph holds
    elastic_engines, windows, lines = {}, {}, []
    for spec, eng_f in engines.items():
        eng_e = ReverseKRanksEngine(eng_f.users, eng_f.rank_table,
                                    eng_f.config, backend="elastic:fused")
        elastic_engines[spec] = eng_e
        report["backends"][spec] = eng_e._backend
        name = ELASTIC_KERNEL[spec]
        for nb, ask, ref_ask in (
                (qs.shape[0], lambda c: eng_e.query_batch(qs, K, c),
                 lambda c: eng_f.query_batch(qs, K, c)),
                (1, lambda c: eng_e.query(q1, K, c),
                 lambda c: eng_f.query(q1, K, c))):
            ops.reset_launch_counts()
            got = [ask(c) for c in (C, C_ODD)]
            sync()
            win = {k: v for k, v in ops.LAUNCHES.items() if v}
            per_run = -(-nb // ops.user_scores.MAX_B)
            # a selection a run of the body: the eager run and the capture
            want_win = {name: 2 * per_run, "select_kth": 2,
                        "select_lemma1": 2} if on_card else {}
            check(win == want_win, f"(a) elastic:fused {spec} B={nb}: "
                  f"launches {win}, expected {want_win}")
            windows[(spec, nb)] = win.get(name, 0)
            prog = next(p for p in eng_e._backend.programs()
                        if p.qs.shape[0] == nb)
            if on_card:
                held = {name: per_run, "select_kth": 1, "select_lemma1": 1}
                check(prog.replays == 2 and prog.recorded == held,
                      f"(a) elastic:fused {spec} B={nb}: {prog.replays} "
                      f"replays holding {prog.recorded}, expected 2 "
                      f"holding {held}")
            lines.append(f"{spec} B={nb}: {win.get(name, 0)} launches of "
                         f"{name}, then {prog.replays} replays of a graph "
                         f"holding {prog.recorded.get(name, 0)}")
            for c, r in zip((C, C_ODD), got):
                same_result(torch, r, ref_ask(c),
                            f"(a) elastic:fused {spec} B={nb} c={c}")
    sync()
    report["launches"] = windows
    print("  (a) launches of the serving path's first runs, each in a "
          "window of its own (one eager run and the capture; replays call "
          "no wrapper): " + "; ".join(lines))
    if on_card:
        # the kernel runs inside the replays: torch.profiler sees it there
        from torch.profiler import ProfilerActivity, profile
        eng_e = elastic_engines["f32"]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                eng_e.query_batch(qs, K, C)
            sync()
        ran = sum(e.count for e in prof.key_averages()
                  if "step1_ring_kernel" in e.key)
        per_run = -(-qs.shape[0] // ops.user_scores.MAX_B)
        check(ran == 3 * per_run, f"(a) torch.profiler saw {ran} runs of "
              f"the ring kernel in 3 replays, expected {3 * per_run}")
        print(f"  (a) torch.profiler over 3 replays of the f32 B="
              f"{qs.shape[0]} program: {ran} runs of step1_ring_kernel")
    report["checks"].append("a")
    print(f"  (a) elastic:fused bitwise fused at f32, bf16 and int8, "
          f"query_batch (B={qs.shape[0]}) and query, c = {C} and {C_ODD}: "
          "indices, est, r_lo/r_up, R_lo_k/R_up_k, guaranteed, n_accepted, "
          "n_pruned")

    # (b) elastic:dense against dense, f32
    eng_f = engines["f32"]
    rt = eng_f.rank_table
    eng_d = ReverseKRanksEngine(users, rt, cfg, backend="dense")
    eng_ed = ReverseKRanksEngine(users, rt, cfg, backend="elastic:dense")
    for c in (C, C_ODD):
        res_e = eng_ed.query_batch(qs, K, c)
        res_d = eng_d.query_batch(qs, K, c)
        bucket = next(iter(eng_ed._backend._buckets.values()))
        f_b = [x[:, :n] for x in query_mod.bound_ranks_batch(
            bucket.rt, bucket.users, qs)]
        check(torch.equal(res_e.r_lo, f_b[0])
              and torch.equal(res_e.r_up, f_b[1]),
              "(b) elastic:dense: the graph's bounds differ from the same "
              "computation outside it")
        d_b = query_mod.bound_ranks_batch(rt, users, qs)
        check_k1(torch, ops, ref, users, qs, rt.thresholds, rt.table, m,
                 f"(b) at capacity c={c}",
                 got=[x.T for x in f_b], name="elastic:dense")
        n_diff, tol = selections_agree(torch, query_mod, res_e, res_d, f_b,
                                       d_b, K, c, m)
        print(f"  (b) elastic:dense c={c}: {n_diff} users selected by one "
              f"of elastic:dense and dense only, all explained (est tol "
              f"{tol:.3g})")
    del eng_ed, res_e, res_d, f_b, d_b
    report["checks"].append("b")

    # (c) no new program across the serving-time changes
    n0 = sweep[1]
    eng_m = ReverseKRanksEngine(
        users[:n0].contiguous(), rt.take_rows(torch.arange(n0, device=dev)),
        cfg, backend="elastic:fused", items=items, positions=pos,
        weights=w)
    bk = eng_m._backend
    count = elastic.elastic_trace_count
    eng_m.query_batch(qs, K, C)                 # warm-up: one program
    eng_m.query(q1, K, C)                       # and one at B = 1

    def step(label, fn, new=0):
        before = count()
        fn()
        sync()
        after = count()
        print(f"  (c) {label}: elastic_trace_count {before} -> {after}")
        check(after - before == new, f"(c) {label}: {after - before} new "
              f"programs, expected {new}")

    def sweep_n():
        for nn in sweep:
            u_n, rt_n = rows_view(users, rt, nn)
            same_result(torch, bk.query_batch(rt_n, u_n, qs, k=K, c=C),
                        FusedBackend().query_batch(rt_n, u_n, qs, k=K, c=C),
                        f"(c) n={nn}")
    step(f"n sweep {', '.join(map(str, sweep))} (capacity "
         f"{elastic.capacity_for(n, bk.tile)}), each bitwise fused", sweep_n)
    step(f"c = {C_ODD}", lambda: eng_m.query_batch(qs, K, C_ODD))
    fresh = items[-6:] * 1.25
    ids = [None]

    def warm_delta():
        ids[0] = eng_m.insert_items(fresh[:3])
        eng_m.delete_items([0, 1, 2])
        eng_m.query_batch(qs, K, C)
    step("delta path warm-up (+3 items, -3 items)", warm_delta, new=1)

    def churn():
        eng_m.insert_items(fresh[3:])
        eng_m.delete_items([3, 4, 5])
        eng_m.query_batch(qs, K, C)
        eng_m.query_batch(qs, K, C_ODD)
    step("item churn on the delta path (+3, -3)", churn)

    def against_fused(label):
        """eng_m's elastic query_batch against the fused backend on the
        same snapshot, at both c: bitwise, or else (the correction's
        product runs over the capacity in the program, over n in fused,
        and cuBLAS may take another algorithm for another row count)
        agreeing by the explained-mismatch rule, the differing cells
        counted."""
        snap = eng_m.current_snapshot()
        u_s, rt_s, corr = snap.query_users(), snap.rank_table, snap.corr
        for c in (C, C_ODD):
            res_e = eng_m.query_batch(qs, K, c)
            res_f = FusedBackend().query_batch(rt_s, u_s, qs, k=K, c=c,
                                               delta=corr)
            bad = differing_fields(torch, res_e, res_f)
            if not bad:
                print(f"  (c) {label}, c={c}: elastic:fused bitwise fused "
                      "on the same snapshot, every field")
                continue
            # both corrected bounds, step 1 shared (its rows are bitwise
            # the elastic entry's), the correction's product over n and
            # over the capacity
            n_s = u_s.shape[0]
            step1 = [x.T for x in FusedBackend().bound_ranks(rt_s, u_s, qs)]
            padded = bk._buckets[next(reversed(bk._buckets))].users
            both = []
            for uu in (padded, u_s):
                sc, sl = query_mod.user_scores_batch(uu, qs)
                both.append([x.T for x in rt_mod.apply_delta_corrections(
                    sc[:n_s], *step1, corr,
                    slack=None if sl is None else sl[:n_s])])
            e_b, f_b = both
            check(torch.equal(e_b[0], res_e.r_lo)
                  and torch.equal(e_b[1], res_e.r_up),
                  f"(c) {label}: the program's bounds are not the "
                  "correction over the capacity's product")
            cells = int(((e_b[0] != f_b[0]) | (e_b[1] != f_b[1])).sum())
            n_diff, tol = selections_agree(torch, query_mod, res_e, res_f,
                                           e_b, f_b, K, c,
                                           corr.selection_m())
            print(f"  (c) {label}, c={c}: fields {bad} differ from fused "
                  f"on the same snapshot; {cells} cells of r_lo/r_up "
                  f"differ, {n_diff} users selected by one only, all "
                  f"explained (est tol {tol:.3g})")
    against_fused("after the item churn")

    def grow():
        eng_m.upsert_users(users[n0:])
        eng_m.query_batch(qs, K, C)
    step(f"append {n - n0} users (n = {n}) on the delta path", grow)
    against_fused(f"after the append (n = {n})")

    def rebuild():
        check(eng_m.rebuild(positions=pos, weights=w) is not None,
              "(c) rebuild did not run")
        eng_m.query_batch(qs, K, C)
    step("rebuild() at n = {n}, m unchanged".format(n=n), rebuild)
    # a replay's bounds against a direct call of the elastic entry
    res = eng_m.query_batch(qs, K, C)
    bucket = bk._buckets[next(reversed(bk._buckets))]
    direct = ops.bound_ranks_batched_stored(
        bucket.users, qs, bucket.rt, torch.tensor([n], dtype=torch.int32,
                                                  device=dev))
    check(torch.equal(res.r_lo, direct[0][:, :n])
          and torch.equal(res.r_up, direct[1][:, :n]),
          "(c) a replay's bounds differ from a direct call of the entry")
    # the same program run eagerly on its static inputs as the replay
    # above left them, against that replay's outputs (every field)
    if on_card:
        prog = next(p for p in bk.programs() if p.bucket is bucket
                    and p.qs.shape[0] == qs.shape[0])
        check(not differing_fields(torch, prog._body(), prog.out),
              "(c) the program run eagerly differs from its replay")
        print("  (c) the B=16 program run eagerly on its static inputs: "
              "every field bitwise its last replay")
    small = elastic.capacity_for(n, bk.tile) // 2 - 1000
    u_s, rt_s = rows_view(users, rt, small)
    step(f"n = {small} (a new bucket)",
         lambda: bk.query_batch(rt_s, u_s, qs, k=K, c=C), new=1)
    replays = sum(p.replays for p in bk.programs())
    print(f"  (c) {len(bk.programs())} programs of this backend, "
          f"{replays} replays; a replay's r_lo/r_up bitwise a direct call "
          "of the elastic entry")
    del eng_m, res, direct
    report["checks"].append("c")

    # (d) MicroBatcher on elastic:fused at f32
    eng_e = elastic_engines["f32"]
    qids = (torch.arange(n_serve, device=dev) * 7 + 3) % m
    qh = items[qids].cpu().numpy()
    want = []
    for b0 in range(0, n_serve, 16):
        r = eng_e.query_batch(torch.from_numpy(qh[b0:b0 + 16]).to(dev), K,
                              C)
        want += [type(r)(*(x[i].cpu() for x in r)) for i in range(16)]

    bk_e = eng_e._backend
    want_idx = torch.stack([r.indices for r in want])

    def burst(depth, keep):
        """n_serve queries submitted by SERVE_THREADS client threads; the
        results taken in submission order. keep=True holds every result
        to the end of the burst (each lands in new host memory the client
        owns); keep=False checks each one's indices and drops it at once,
        as a client that is done with it would, so the host memory of
        the results is reused. The launches are counted in a window of
        the burst's own: every tick replays the program captured in (a),
        so the window holds none and the replays are one a tick. Returns
        (results held, wall s, the MicroBatcher)."""
        futs = [None] * n_serve
        replays0 = sum(p.replays for p in bk_e.programs())
        ops.reset_launch_counts()
        mb = MicroBatcher(eng_e, max_batch=16, max_wait_ms=2.0,
                          pipeline_depth=depth)
        out = []
        try:
            def client(t):
                for i in range(t, n_serve, SERVE_THREADS):
                    futs[i] = mb.submit(qh[i], K, C)
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(t,))
                       for t in range(SERVE_THREADS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
            for i, f in enumerate(futs):
                r = f.result(timeout=120)
                if keep:
                    out.append(r)
                else:
                    check(torch.equal(r.indices, want_idx[i]),
                          f"(d) depth {depth} query {i}: indices differ")
                del r
            wall = time.perf_counter() - t0
        finally:
            mb.close()
        sync()
        win = {k: v for k, v in ops.LAUNCHES.items() if v}
        ticks = sum(1 for t in mb.tick_log if t.batch > 0)
        replays = sum(p.replays for p in bk_e.programs()) - replays0
        check(not win, f"(d) depth {depth}: wrapper launches {win} in the "
              "burst, where every tick should replay")
        if on_card:
            check(replays == ticks, f"(d) depth {depth}: {replays} replays "
                  f"for {ticks} ticks")
        print(f"  (d) depth {depth}, results {'held' if keep else 'dropped'}"
              f": launches in the burst's window {win}; {replays} replays "
              f"for {ticks} ticks")
        return out, wall, mb

    serve_stats = {}
    for keep in (True, False):
        for depth in (1, 2):
            got, wall, mb = burst(depth, keep)
            for i, r in enumerate(got):
                same_result(torch, r, want[i],
                            f"(d) pipeline_depth={depth} query {i}")
            del got
            st, log = mb.stats(), mb.tick_log
            ticks = [t for t in log if t.batch > 0]
            check(sum(t.compiles for t in ticks) == 0,
                  f"(d) depth {depth}: programs built while serving")
            copy_ms = np.array([t.copy_ms for t in ticks])
            copy_mb = np.array([t.copy_bytes for t in ticks]) / 1e6
            stats = serve_stats[(keep, depth)] = dict(
                p50_ms=st.p50_ms, p99_ms=st.p99_ms, fill=st.mean_fill,
                overlap=st.overlap_efficiency, qps=n_serve / wall,
                ticks=len(ticks), copy_ms=float(copy_ms.mean()),
                copy_mb=float(copy_mb.mean()),
                transfer_ms=float(np.mean([t.transfer_ms for t in ticks])),
                rows_ms=float(np.mean([t.rows_ms for t in ticks])))
            how = ("every result held to the end, every field of every "
                   "result bitwise its row of a synchronous query_batch"
                   if keep else "each result dropped once its indices "
                   "are checked (bitwise)")
            print(f"  (d) MicroBatcher elastic:fused f32, pipeline_depth="
                  f"{depth}: {n_serve} queries from {SERVE_THREADS} threads "
                  f"in {wall * 1e3:.1f} ms ({n_serve / wall:.1f} queries/s)"
                  f"; {len(ticks)} ticks, fill {st.mean_fill:.3f}, p50 "
                  f"{st.p50_ms:.3f} ms, p99 {st.p99_ms:.3f} ms, overlap "
                  f"efficiency {st.overlap_efficiency:.3f}, compiles per "
                  f"tick {sum(t.compiles for t in ticks)} in all; copy to "
                  f"the host per tick {copy_ms.mean():.3f} ms device time "
                  f"(min {copy_ms.min():.3f}, max {copy_ms.max():.3f}) for "
                  f"{copy_mb.mean():.2f} MB; completion stage per tick: "
                  f"wait {stats['transfer_ms']:.3f} ms, the rows' copy-out "
                  f"into the results' memory {stats['rows_ms']:.3f} ms; "
                  f"{how}")
    report["serve"] = serve_stats
    if timing:
        q16 = torch.from_numpy(qh[:16]).to(dev)
        tick_ms = time_ms(torch, lambda: eng_e.query_batch(q16, K, C),
                          reps=20)
        report["tick_ms"] = tick_ms
        print(f"  (d) one 16-wide elastic:fused query_batch (replay, "
              f"outputs copied out on the card): {tick_ms:.3f} ms by CUDA "
              f"events; the tick's copy of the result to the host "
              f"{serve_stats[(True, 2)]['copy_ms']:.3f} ms, "
              f"{serve_stats[(True, 2)]['copy_ms'] / tick_ms:.2f} of it")
        eng_f = engines["f32"]
        for label, fn in (
                ("fused query_batch(B=16)", lambda: eng_f.query_batch(
                    q16, K, C)),
                ("elastic:fused query_batch(B=16)",
                 lambda: eng_e.query_batch(q16, K, C)),
                ("fused query", lambda: eng_f.query(q1, K, C)),
                ("elastic:fused query", lambda: eng_e.query(q1, K, C))):
            ms = time_ms(torch, fn, reps=50)
            print(f"  (d) {label}: {ms:.3f} ms a call, 50 calls back to "
                  "back by CUDA events (host work included where the "
                  "card waits on it)")
    report["checks"].append("d")

    # (e) cached:elastic:fused: repeated queries resolve at admission
    eng_c = ReverseKRanksEngine(users, rt, cfg,
                                backend="cached:elastic:fused")
    mb = MicroBatcher(eng_c, max_batch=16, max_wait_ms=2.0)
    try:
        first = [mb.submit(qh[i], K, C) for i in range(32)]
        first = [f.result(timeout=120) for f in first]
        hits0 = mb.stats().admission_hits
        again = [mb.submit(qh[i], K, C) for i in range(32)]
        again = [f.result(timeout=120) for f in again]
        hits = mb.stats().admission_hits - hits0
    finally:
        mb.close()
    check(hits == 32, f"(e) {hits} of 32 repeated queries hit at admission")
    for i in range(32):
        same_result(torch, again[i], want[i], f"(e) admission hit {i}")
        same_result(torch, first[i], want[i], f"(e) first ask {i}")
    print("  (e) cached:elastic:fused: 32 queries asked twice, the second "
          "time all 32 resolved at admission; all bitwise")
    del eng_c, first, again
    report["checks"].append("e")

    # (f) an injected serve.transfer fault fails exactly that tick
    plan = faults.install(faults.FaultPlan(seed=0, rules=[
        faults.FaultRule("serve.transfer", max_fires=1)]))
    mb = MicroBatcher(eng_e, max_batch=16, max_wait_ms=50.0)
    try:
        batch1 = [mb.submit(qh[i], K, C) for i in range(16)]
        wait_futures(batch1, timeout=120)
        batch2 = [mb.submit(qh[i], K, C) for i in range(16, 32)]
        got2 = [f.result(timeout=120) for f in batch2]
        log = mb.tick_log
    finally:
        mb.close()
        faults.clear()
    failed = [f for f in batch1 if isinstance(f.exception(timeout=1),
                                              faults.InjectedFault)]
    check(len(failed) == 16 and plan.fires["serve.transfer"] == 1,
          f"(f) {len(failed)} of the faulted tick's 16 futures failed "
          f"typed, {plan.fires['serve.transfer']} fires")
    for i, r in enumerate(got2):
        same_result(torch, r, want[16 + i], f"(f) next tick query {i}")
    print(f"  (f) serve.transfer fault: the faulted tick's 16 futures "
          f"failed with InjectedFault, the next tick served 16 bitwise; "
          f"{len(log)} tick records")
    report["checks"].append("f")

    # (g) close(drain_s) with ticks in flight
    mb = MicroBatcher(eng_e, max_batch=16, max_wait_ms=0.5,
                      pipeline_depth=2)
    futs = []
    try:
        futs = [mb.submit(qh[i], K, C) for i in range(min(128, n_serve))]
    finally:
        mb.close(drain_s=0.002)
    served = shed = 0
    for i, f in enumerate(futs):
        check(f.done(), f"(g) future {i} unresolved after close")
        e = f.exception(timeout=0)
        if e is None:
            same_result(torch, f.result(), want[i], f"(g) query {i}")
            served += 1
        else:
            check(isinstance(e, SchedulerClosed),
                  f"(g) future {i} failed with {type(e).__name__}")
            shed += 1
    print(f"  (g) close(drain_s=0.002) with ticks in flight: {served} "
          f"served bitwise, {shed} shed with SchedulerClosed, none "
          "unresolved")
    report["checks"].append("g")
    return report


# ----------------------------------------- durability, maintenance, audit
AUDIT_FRACTION = 0.05              # phase 7 (e)'s sampled share
LOOP_INSERT = 96                   # phase 7 (c)'s inserts, in 4 batches
SPILLS_NEEDED = 3                  # spills a directory holds at its peak


def spill_estimate(snap) -> int:
    """The bytes of the arrays a spill of `snap` stores (users, the packed
    table, the base items, the inserted items), before the npz framing."""
    sz = lambda t: 0 if t is None else t.numel() * t.element_size()
    rt = snap.rank_table
    total = sz(snap.users) + sz(snap.base.items) + sum(
        sz(getattr(rt, f)) for f in ("thresholds", "table", "thr_scale",
                                     "thr_off", "tab_scale", "tab_off",
                                     "thr_dev"))
    return total + sz(snap.delta.added_items)


def engines_equal(torch, np, got, want, qs, q1, label):
    """Check that a restored engine is bitwise the engine it stands for:
    the epoch, the users, every RankTable field, the delta state, the
    stored users, the correction, the base's sampling state, the
    generator's state, user_remap, and every field of query_batch(qs)
    and query(q1)."""
    gs, ws = got.current_snapshot(), want.current_snapshot()
    check(gs.epoch == ws.epoch, f"{label}: epoch {gs.epoch} != {ws.epoch}")
    check(got._next_item_id == want._next_item_id,
          f"{label}: the next item id differs")

    def same(a, b, what):
        check((a is None) == (b is None)
              and (a is None or (a.dtype == b.dtype and a.shape == b.shape
                                 and torch.equal(a, b))),
              f"{label}: {what} differs")

    same(gs.users, ws.users, "users")
    for f in ws.rank_table._fields:
        if f == "m":
            check(gs.rank_table.m == ws.rank_table.m, f"{label}: m differs")
        else:
            same(getattr(gs.rank_table, f), getattr(ws.rank_table, f),
                 f"rank_table.{f}")
    for f in ("base_live", "added_ids", "user_live"):
        check(np.array_equal(getattr(gs.delta, f), getattr(ws.delta, f)),
              f"{label}: delta.{f} differs")
    check(gs.delta.touched_users == ws.delta.touched_users,
          f"{label}: delta.touched_users differs")
    same(gs.delta.added_items, ws.delta.added_items, "delta.added_items")
    check((gs.stored_users is None) == (ws.stored_users is None),
          f"{label}: stored users present in one engine only")
    if ws.stored_users is not None:
        for f in ws.stored_users._fields:
            same(getattr(gs.stored_users, f), getattr(ws.stored_users, f),
                 f"stored_users.{f}")
    check((gs.corr is None) == (ws.corr is None),
          f"{label}: a correction in one engine only")
    if ws.corr is not None:
        check(gs.corr.m_new == ws.corr.m_new, f"{label}: m_new differs")
        for f in ws.corr._fields:
            if f != "m_new":
                same(getattr(gs.corr, f), getattr(ws.corr, f), f"corr.{f}")
    for f in ("items", "positions", "weights", "samples", "order"):
        same(getattr(gs.base, f), getattr(ws.base, f), f"base.{f}")
    check(np.array_equal(gs.base.item_ids, ws.base.item_ids),
          f"{label}: base item ids differ")
    gg, wg = got._generator_state, want._generator_state
    check((gg is None) == (wg is None)
          and (gg is None or torch.equal(gg[1], wg[1])),
          f"{label}: the generator's state differs")
    check((gs.user_remap is None) == (ws.user_remap is None)
          and (ws.user_remap is None
               or np.array_equal(gs.user_remap, ws.user_remap)),
          f"{label}: user_remap differs")
    same_result(torch, got.query_batch(qs, K, C), want.query_batch(qs, K, C),
                f"{label}: query_batch(B={qs.shape[0]})")
    same_result(torch, got.query(q1, K, C), want.query(q1, K, C),
                f"{label}: query")


def durability_checks(dev, *, users, items, cfg, rt, pos, w, qs, grades,
                      pruned, n=N, m=M, d=D, tau=TAU, n_serve=SERVE_Q,
                      gen_seed=1, avoid=None, timing=True):
    """Phase 7: durability, the maintenance loop and the quality auditor
    on the card (or, for a rehearsal, the CPU), each check fatal.

    `users`, `items`, `cfg`, `rt`, `pos`, `w`, `qs` are phase 4's (its
    samples drawn by a generator seeded `gen_seed`), `grades` its per-query
    (accuracy, overall ratio) lists of the fused engine, `pruned` phase
    4c (iii)'s (users, rank table, hot batch, skip rate, fallback).

      (a) phase 4d's data and churn on an f32 fused engine built with
          seed BUILD_SEED under an IndexPersister: the spill's bytes and
          its stages' times, each WAL append's latency; `restore` on the
          device, bitwise the running engine (epoch, users, every
          RankTable field, delta state, stored users, correction,
          sampling state, user_remap, query_batch and query); then both
          rebuilt, bitwise again; the same at int8 (a packed spill);
      (b) `swap_s` of the rebuild with a persister (the spill under the
          mutation lock) and without (the restored engine's), and the
          wait of an insert_items issued while a rebuild's spill holds
          the lock;
      (c) MaintenanceLoop with a persister on a mutable elastic:fused
          engine over phase 4's table and samples: 4 client threads
          serve through MicroBatcher (depth 2) while a thread inserts 96
          items in 4 batches; the policy fires once, after the fourth;
          the loop rebuilds; programs are built once for each new key
          (the delta widths 32, 64 and 128, then the static path at
          m + 96) and never per tick; every result (indices, est, R_k,
          guaranteed, counters bitwise, r_lo/r_up by the CRC32 of their
          bytes) is its snapshot's synchronous query_batch;
      (d) a QualityAuditor at fraction 1.0 behind MicroBatcher on phase
          4's queries: its overall ratio and accuracy equal the mean of
          phase 4's own grades (rtol 1e-12), 16 scored with one K3
          launch each;
      (e) phase 6's burst (n_serve queries from 4 threads, depth 1 and 2,
          results held) without an auditor, with one at AUDIT_FRACTION,
          and with one and the dispatch stream at priority 0 in place
          of the scheduler's −1 (`_DISPATCH_STREAM_PRIORITY`):
          queries/s, p50/p99, the auditor's backlog and flush time; in
          each audited burst's launch window K3 launches = scored;
      (f) on phase 4c (iii)'s engine and hot batch, the
          `prune_skip_rate` gauge equals the backend's
          `stats.skip_rate`; the mean `prune.phase_a` / `prune.phase_b`
          span times beside the query's time.

    Returns a report: the checks passed and the numbers printed."""
    import os
    import shutil
    import tempfile
    import threading
    import zlib
    import numpy as np
    import torch
    from repro_torch.core import elastic
    from repro_torch.core.backends import PrunedBackend
    from repro_torch.core.engine import ReverseKRanksEngine
    from repro_torch.core.types import RankTableConfig
    from repro_torch.data.pipeline import synthetic_embeddings
    from repro_torch.index import (IndexPersister, MaintenanceLoop,
                                   MaintenancePolicy)
    from repro_torch.kernels import ops
    from repro_torch.obs import QualityAuditor
    from repro_torch.obs import registry as obs
    from repro_torch.obs import trace
    from repro_torch.serve import MicroBatcher, scheduler
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    report = {"checks": []}

    class TimedPersister(IndexPersister):
        """An IndexPersister that times each WAL append and flags each
        spill as it starts."""

        def __init__(self, path):
            super().__init__(path)
            self.appends = []
            self.spilling = threading.Event()

        def spill(self, *a, **kw):
            self.spilling.set()
            return super().spill(*a, **kw)

        def append(self, op, arrays):
            t0 = time.perf_counter()
            ok = super().append(op, arrays)
            self.appends.append((op, time.perf_counter() - t0))
            check(ok, f"the WAL append of {op} failed")
            return ok

    def spill_line(p, what):
        st = p.last_spill
        return (f"{what}: {st.bytes} bytes in "
                f"{st.d2h_s + st.encode_s + st.write_s:.3f} s (copies to "
                f"the host {st.d2h_s:.3f} s, npz encode and CRC32 "
                f"{st.encode_s:.3f} s, write, fsync and rename "
                f"{st.write_s:.3f} s)")

    tmp = tempfile.mkdtemp(prefix="spills-")
    try:
        # (a) spill, WAL and restore on phase 4d's data and churn
        users_d, items_d, qs_d, q1_d, churn = delta_data(
            torch, synthetic_embeddings, dev, n, m, d, *CHURN.values(), B,
            avoid)
        q1 = q1_d[0]
        cfgs = {spec: RankTableConfig(tau=tau, omega=OMEGA, s=S_PER,
                                      storage_dtype=spec)
                for spec in ("f32", "int8")}
        eng = ReverseKRanksEngine.build(users_d, items_d, cfgs["f32"],
                                        BUILD_SEED, backend="fused",
                                        device=dev)
        need = spill_estimate(eng.current_snapshot())
        free = shutil.disk_usage(tmp).free
        print(f"  spill directory {tmp}: {free} bytes free; an f32 spill "
              f"stores about {need} bytes, {SPILLS_NEEDED} of them "
              f"{SPILLS_NEEDED * need}")
        check(free >= SPILLS_NEEDED * need,
              f"{free} bytes free in {tmp}, below the {SPILLS_NEEDED * need}"
              f" bytes of {SPILLS_NEEDED} f32 spills")
        spills = {}
        d32 = os.path.join(tmp, "f32")
        p32 = TimedPersister(d32)
        eng.attach_persister(p32)
        spills["f32"] = p32.last_spill
        print("  (a) " + spill_line(p32, "f32 baseline spill (attach)"))
        churn.apply(torch, ops, eng)
        sync()
        print("  (a) WAL appends, each with its fsync: " + "; ".join(
            f"{op} {s * 1e3:.3f} ms" for op, s in p32.appends))
        t0 = time.perf_counter()
        got = ReverseKRanksEngine.restore(d32, backend="fused", device=dev)
        sync()
        restore_s = time.perf_counter() - t0
        engines_equal(torch, np, got, eng, qs_d, q1, "(a) f32 restore")
        print(f"  (a) restore on {dev.type} {restore_s:.3f} s (read, "
              f"checks, rebuild of the snapshot, {len(p32.appends)} WAL "
              "records replayed): bitwise the running engine: epoch, "
              "users, every RankTable field, delta state, correction, "
              "sampling state, generator state, user_remap, query_batch "
              f"(B={B}) and query")
        rec_p = eng.rebuild()
        rec_n = got.rebuild()
        sync()
        check(rec_p is not None and rec_n is not None,
              "(a) a rebuild did not run")
        engines_equal(torch, np, got, eng, qs_d, q1,
                      "(a) f32 rebuild after restore")
        print("  (a) " + spill_line(p32, "f32 rebuild spill"))
        print("  (a) rebuild() of both: bitwise equal again")
        report["checks"].append("a")

        # (b) the rebuild's locked spill
        print(f"  (b) swap_s of rebuild(): {rec_p.swap_s:.4f} s with a "
              f"persister (its spill under the mutation lock), "
              f"{rec_n.swap_s:.4f} s without; build_s {rec_p.build_s:.4f}"
              f" / {rec_n.build_s:.4f} s")
        extra = items_d[:8] * 1.01
        sync()
        t0 = time.perf_counter()
        eng.insert_items(extra[:4])
        sync()
        free_insert = time.perf_counter() - t0
        p32.spilling.clear()
        out = {}
        th = threading.Thread(target=lambda: out.update(rec=eng.rebuild()))
        th.start()
        check(p32.spilling.wait(timeout=300),
              "(b) the rebuild's spill never started")
        t0 = time.perf_counter()
        eng.insert_items(extra[4:])
        sync()
        waited = time.perf_counter() - t0
        th.join(timeout=600)
        check(not th.is_alive() and out.get("rec") is not None,
              "(b) the concurrent rebuild did not finish")
        print(f"  (b) insert_items(4 items) issued once the rebuild's spill "
              f"had started returned after {waited:.3f} s (rebuild swap_s "
              f"{out['rec'].swap_s:.3f} s); insert_items(4 items) with no "
              f"spill in progress {free_insert * 1e3:.3f} ms (both with "
              "their WAL append)")
        report["b"] = dict(with_persister=rec_p.swap_s,
                           without=rec_n.swap_s, insert_wait=waited,
                           insert_free=free_insert)
        report["checks"].append("b")
        p32.close()
        del eng, got, rec_p, rec_n
        shutil.rmtree(d32, ignore_errors=True)

        # (a) again at int8: the packed spill
        eng = ReverseKRanksEngine.build(users_d, items_d, cfgs["int8"],
                                        BUILD_SEED, backend="fused",
                                        device=dev)
        d8 = os.path.join(tmp, "int8")
        p8 = TimedPersister(d8)
        eng.attach_persister(p8)
        spills["int8"] = p8.last_spill
        print("  (a) " + spill_line(p8, "int8 baseline spill (attach)"))
        churn.apply(torch, ops, eng)
        t0 = time.perf_counter()
        got = ReverseKRanksEngine.restore(d8, backend="fused", device=dev)
        sync()
        restore8 = time.perf_counter() - t0
        engines_equal(torch, np, got, eng, qs_d, q1, "(a) int8 restore")
        check(eng.rebuild() is not None and got.rebuild() is not None,
              "(a) an int8 rebuild did not run")
        engines_equal(torch, np, got, eng, qs_d, q1,
                      "(a) int8 rebuild after restore")
        print(f"  (a) int8: restore {restore8:.3f} s, bitwise; rebuild() of "
              "both bitwise again; " + spill_line(p8, "int8 rebuild spill"))
        p8.close()
        del eng, got
        shutil.rmtree(d8, ignore_errors=True)
        report["spills"] = spills
        report["restore_s"] = restore_s
        report["wal"] = list(p32.appends)
        del users_d, items_d, qs_d, churn

        # (c) the maintenance loop under serving
        g = torch.Generator(device=dev)
        g.manual_seed(gen_seed)
        eng_c = ReverseKRanksEngine(users, rt, cfg, backend="elastic:fused",
                                    items=items, positions=pos, weights=w,
                                    generator_state=(dev, g.get_state()))
        check(torch.equal(eng_c._draw(m)[0], pos),
              "(c) the generator state does not draw phase 4's samples")
        dc = os.path.join(tmp, "loop")
        pc = TimedPersister(dc)
        eng_c.attach_persister(pc)
        print("  (c) " + spill_line(pc, "baseline spill (attach)"))
        qids = (torch.arange(n_serve, device=dev) * 7 + 3) % m
        qh = items[qids].cpu().numpy()
        new = (items[-LOOP_INSERT:] * 1.25).contiguous()
        per = LOOP_INSERT // 4
        eng_c.query_batch(torch.from_numpy(qh[:16]).to(dev), K, C)  # warm
        sync()
        served, lock = [], threading.Lock()

        class Recorder:
            """The auditor hook of MicroBatcher, used to record what each
            resolved request was served from: its query, its snapshot, its
            small fields and the CRC32 of its r_lo / r_up bytes."""

            def observe(self, q, result, *, k, c, snapshot=None):
                crc = tuple(zlib.crc32(np.ascontiguousarray(getattr(
                    result, f).numpy())) for f in ("r_lo", "r_up"))
                small = tuple(getattr(result, f) for f in result._fields
                              if f not in ("r_lo", "r_up"))
                with lock:
                    served.append((np.array(q), snapshot, small, crc))
                return False

        # fires after the fourth batch, not the third
        policy = MaintenancePolicy(max_delta_ratio=(LOOP_INSERT - per / 2)
                                   / m)
        programs0 = elastic.elastic_trace_count()
        stop = threading.Event()
        errors = []
        mb = MicroBatcher(eng_c, max_batch=16, max_wait_ms=2.0,
                          pipeline_depth=2, auditor=Recorder())
        ml = MaintenanceLoop(eng_c, policy=policy, poll_ms=5.0)
        insert_s = []
        try:
            def client(t):
                i = t
                try:
                    while not stop.is_set():
                        futs = []
                        for _ in range(8):
                            futs.append(mb.submit(qh[i % n_serve], K, C))
                            i += SERVE_THREADS
                        for f in futs:
                            f.result(timeout=300)
                except Exception as e:          # reported below
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(t,))
                       for t in range(SERVE_THREADS)]
            t_start = time.perf_counter()
            for th in threads:
                th.start()
            for j in range(4):
                time.sleep(0.1)
                t0 = time.perf_counter()
                eng_c.insert_items(new[per * j:per * (j + 1)])
                insert_s.append(time.perf_counter() - t0)
            deadline = time.monotonic() + 600
            while not ml.rebuilds and time.monotonic() < deadline:
                ml.wake()
                time.sleep(0.01)
            time.sleep(0.3)             # serve the rebuilt epoch a while
            stop.set()
            for th in threads:
                th.join(timeout=300)
            wall = time.perf_counter() - t_start
        finally:
            stop.set()
            ml.close()
            mb.close()
        sync()
        programs1 = elastic.elastic_trace_count()
        check(not errors, f"(c) client errors: {errors[:3]}")
        check(len(ml.rebuilds) == 1 and not ml.failures,
              f"(c) {len(ml.rebuilds)} rebuilds, {len(ml.failures)} "
              "failures, expected one rebuild")
        rec = ml.rebuilds[0]
        check(rec.reason.startswith("delta_ratio")
              and eng_c.rank_table.m == m + LOOP_INSERT,
              f"(c) the rebuild ({rec.reason}) did not absorb the inserts")
        ticks = [t for t in mb.tick_log if t.batch > 0]
        compiles = sum(t.compiles for t in ticks)
        check(programs1 - programs0 == 4 and compiles == 4,
              f"(c) {programs1 - programs0} programs built ({compiles} in "
              "ticks), expected 4: the delta widths 32, 64, 128 and the "
              f"static path at m + {LOOP_INSERT}, each once")
        epochs = sorted({s.epoch for _, s, _, _ in served})
        check(epochs[0] == 0 and epochs[-1] == eng_c.epoch,
              f"(c) served epochs {epochs} do not span the run")
        by_epoch = {}
        for q, snap, small, crc in served:
            by_epoch.setdefault(snap.epoch, (snap, []))[1].append(
                (q, small, crc))
        for ep, (snap, rows) in by_epoch.items():
            for b0 in range(0, len(rows), 16):
                blk = rows[b0:b0 + 16]
                qb = np.stack([r[0] for r in blk])
                if qb.shape[0] < 16:
                    qb = np.concatenate([qb, np.repeat(
                        qb[-1:], 16 - qb.shape[0], 0)])
                want = eng_c.query_batch_at(snap, torch.from_numpy(qb).to(
                    dev), K, C)
                want = type(want)(*(x.cpu() for x in want))
                for i, (q, small, crc) in enumerate(blk):
                    wsmall = tuple(getattr(want, f)[i] for f in
                                   want._fields if f not in ("r_lo", "r_up"))
                    wcrc = tuple(zlib.crc32(np.ascontiguousarray(
                        getattr(want, f)[i].numpy())) for f in ("r_lo",
                                                                "r_up"))
                    check(all(torch.equal(a, b) for a, b in
                              zip(small, wsmall)) and crc == wcrc,
                          f"(c) a result of epoch {ep} differs from its "
                          "snapshot's synchronous query_batch")
        reg = obs.get_default()
        st = mb.stats()
        print(f"  (c) MaintenanceLoop + IndexPersister on elastic:fused, "
              f"{SERVE_THREADS} client threads through MicroBatcher "
              f"(depth 2) for {wall:.2f} s while {LOOP_INSERT} items were "
              f"inserted in "
              f"4 batches (insert_items {', '.join(f'{s * 1e3:.2f}' for s in insert_s)}"
              f" ms): {len(served)} results over epochs {epochs}, each "
              f"bitwise its snapshot's query_batch; one rebuild "
              f"({rec.reason}): maintenance_build_ms "
              f"{reg.histogram('maintenance_build_ms').sum:.3f}, "
              f"maintenance_swap_ms {reg.histogram('maintenance_swap_ms').sum:.3f}"
              f" (its spill: {pc.last_spill.bytes} bytes); programs built "
              f"{programs1 - programs0} (all in ticks after a mutation, one "
              f"per new key), elastic_trace_count {programs0} -> "
              f"{programs1}; p50 {st.p50_ms:.3f} ms, p99 {st.p99_ms:.3f} ms")
        report["c"] = dict(build_ms=rec.build_s * 1e3,
                           swap_ms=rec.swap_s * 1e3, results=len(served),
                           p50=st.p50_ms, p99=st.p99_ms)
        report["checks"].append("c")
        pc.close()
        del eng_c, served, by_epoch, mb, ml
        shutil.rmtree(dc, ignore_errors=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (d) the auditor's numbers on phase 4's queries
    eng_a = ReverseKRanksEngine(users, rt, cfg, backend="elastic:fused",
                                items=items, positions=pos, weights=w)
    reg_a = obs.MetricsRegistry()
    aud = QualityAuditor(eng_a, fraction=1.0, seed=0, registry=reg_a)
    mb = MicroBatcher(eng_a, max_batch=16, max_wait_ms=2.0, auditor=aud)
    qh4 = qs.cpu().numpy()
    sync()
    ops.reset_launch_counts()
    try:
        futs = [mb.submit(q, K, C) for q in qh4]
        for f in futs:
            f.result(timeout=300)
        mb.flush()
        t0 = time.perf_counter()
        check(aud.flush(timeout=600), "(d) the auditor did not drain")
        flush_s = time.perf_counter() - t0
    finally:
        mb.close()
        aud.close()
    sync()
    k3 = ops.LAUNCHES["k3_exact_ranks"]
    accs, ratios = grades
    mean = lambda xs: sum(xs) / len(xs)
    scored = reg_a.counter("audit_scored_total").value
    check(scored == len(qh4) and (k3 == scored or not on_card),
          f"(d) {scored} scored with {k3} K3 launches, expected "
          f"{len(qh4)} and one each")
    check(math.isclose(aud.overall_ratio, mean(ratios), rel_tol=1e-12)
          and math.isclose(aud.accuracy, mean(accs), rel_tol=1e-12),
          f"(d) the auditor's overall ratio {aud.overall_ratio!r} / "
          f"accuracy {aud.accuracy!r} differ from phase 4's "
          f"{mean(ratios)!r} / {mean(accs)!r}")
    print(f"  (d) QualityAuditor at fraction 1.0 behind MicroBatcher on "
          f"phase 4's {len(qh4)} queries: audit_scored_total {scored:.0f}, "
          f"{k3} K3 launches (one a sample, on the auditor's stream); "
          f"overall ratio {aud.overall_ratio!r}, accuracy "
          f"{aud.accuracy!r}, equal to phase 4's grades (rtol 1e-12); "
          f"bound width {aud.bound_width:.3f}; the flush after the last "
          f"result {flush_s:.3f} s")
    report["checks"].append("d")

    # (e) the auditor's cost under phase 6's burst
    def burst(depth, audit, priority):
        reg_e = obs.MetricsRegistry()
        aud_e = (QualityAuditor(eng_a, fraction=AUDIT_FRACTION, seed=depth,
                                registry=reg_e) if audit else None)
        futs = [None] * n_serve
        # the baseline switches the scheduler's private constant for the
        # stream this MicroBatcher makes, then puts it back
        fixed = scheduler._DISPATCH_STREAM_PRIORITY
        scheduler._DISPATCH_STREAM_PRIORITY = priority
        try:
            mb_e = MicroBatcher(eng_a, max_batch=16, max_wait_ms=2.0,
                                pipeline_depth=depth, auditor=aud_e)
        finally:
            scheduler._DISPATCH_STREAM_PRIORITY = fixed
        sync()
        ops.reset_launch_counts()
        try:
            def client(t):
                for i in range(t, n_serve, SERVE_THREADS):
                    futs[i] = mb_e.submit(qh[i], K, C)
            t0 = time.perf_counter()
            ths = [threading.Thread(target=client, args=(t,))
                   for t in range(SERVE_THREADS)]
            for th in ths:
                th.start()
            for th in ths:
                th.join(timeout=300)
            held = [f.result(timeout=300) for f in futs]
            wall = time.perf_counter() - t0
            backlog = reg_e.gauge("audit_backlog").value if audit else 0.0
            t1 = time.perf_counter()
            if audit:
                check(aud_e.flush(timeout=600),
                      "(e) the auditor did not drain within 600 s")
            flush_s = time.perf_counter() - t1
        finally:
            mb_e.close()
            if aud_e is not None:
                aud_e.close()
        sync()
        k3 = ops.LAUNCHES["k3_exact_ranks"]
        scored = reg_e.counter("audit_scored_total").value if audit else 0
        check(k3 == scored or not on_card,
              f"(e) {k3} K3 launches for {scored} scored")
        st = mb_e.stats()
        del held
        return dict(qps=n_serve / wall, p50=st.p50_ms, p99=st.p99_ms,
                    backlog=backlog, flush_s=flush_s, scored=scored, k3=k3)

    qids = (torch.arange(n_serve, device=dev) * 7 + 3) % m
    qh = items[qids].cpu().numpy()
    cost = {}
    for depth in (1, 2):
        for label, audit, prio in (("none", False, -1),
                                   ("audit, priority 0", True, 0),
                                   ("audit", True, -1)):
            r = cost[(depth, label)] = burst(depth, audit, prio)
            print(f"  (e) depth {depth}, {label}: {r['qps']:.1f} queries/s, "
                  f"p50 {r['p50']:.3f} ms, p99 {r['p99']:.3f} ms; auditor "
                  f"backlog at the burst's end {r['backlog']:.0f}, flush "
                  f"{r['flush_s']:.3f} s, {r['scored']:.0f} scored, K3 "
                  f"launches in the window {r['k3']}")
    report["e"] = cost
    report["checks"].append("e")
    del eng_a

    # (f) the pruned path's telemetry on phase 4c (iii)'s engine
    users_m, rt_m, qs_hot, skip_iii, fallback_iii = pruned
    eng_f = ReverseKRanksEngine(users_m, rt_m, cfg,
                                backend=PrunedBackend("fused"))
    eng_f.query_batch(qs_hot, K, C)
    reg = obs.get_default()
    label = {"fallback": fallback_iii or "none"}
    before = reg.counter("prune_batches_total", labels=label).value
    was = trace.is_enabled()
    trace.enable()
    trace.clear()
    reps = 10
    try:
        for _ in range(reps):
            eng_f.query_batch(qs_hot, K, C)
            sync()
        spans = {name: [s.duration_ms for s in trace.spans(name)]
                 for name in ("prune.query", "prune.phase_a",
                              "prune.phase_b")}
    finally:
        if not was:
            trace.disable()
        trace.clear()
    st = eng_f._backend.stats
    gauge = reg.gauge("prune_skip_rate").value
    check(gauge == st.skip_rate and st.skip_rate == skip_iii
          and st.fallback == fallback_iii,
          f"(f) prune_skip_rate {gauge} vs stats.skip_rate {st.skip_rate} "
          f"(phase 4c (iii): {skip_iii}), fallback {st.fallback!r}")
    check(reg.counter("prune_batches_total", labels=label).value - before
          == reps and len(spans["prune.query"]) == reps
          and len(spans["prune.phase_a"]) == reps
          and len(spans["prune.phase_b"]) == (0 if st.fallback else reps),
          "(f) a pruned batch published no counter or not its spans")
    q_ms = time_ms(torch, lambda: eng_f.query_batch(qs_hot, K, C),
                   reps=reps) if timing else float("nan")
    mean_of = lambda xs: sum(xs) / len(xs) if xs else float("nan")
    print(f"  (f) pruned:fused on 4c (iii): prune_skip_rate gauge {gauge!r}"
          f" = stats.skip_rate; span means (host clock, {reps} calls): "
          f"prune.query {mean_of(spans['prune.query']):.3f} ms, "
          f"prune.phase_a {mean_of(spans['prune.phase_a']):.3f} ms (its "
          f"host sync included), prune.phase_b "
          f"{mean_of(spans['prune.phase_b']):.3f} ms; query_batch "
          f"{q_ms:.3f} ms by CUDA events")
    report["f"] = dict(spans={k: mean_of(v) for k, v in spans.items()},
                       query_ms=q_ms)
    report["checks"].append("f")
    report["checks"].sort()
    return report


# ------------------------------------------------- row-sharded execution
# Phase 8's n': the first 479,232 users, 117 blocks of 4,096 rows, so it
# splits into whole 256-row blocks for every P up to 16 (the build needs
# n % P == 0, pruned:sharded n % (P·256) == 0, and N = 3·67·2389 meets
# neither for P = 2); m = 17,770 stays whole (2·5·1777: even).
N_CUT = 479_232
P_QUERY, P_BUILD = 3, 2            # shards of (a), and of (b)-(d)
QSRP_LEVELS = 2 * TAU              # the summary of the rank table's size
QSRP_BLOCK = 4096                  # users a chunk of the QSRP build


def sharded_digest(torch, res) -> str:
    """SHA-256 of a sharded query_batch's indices and candidate bounds."""
    import hashlib
    h = hashlib.sha256()
    for x in (res.indices, res.r_lo, res.r_up):
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def sharded_checks(dev, *, users, items, cfg, pos, w, qs, rt, int8, truth,
                   exact_idx, mid, qs_hot, q1=None, n_cut=N_CUT,
                   p_query=P_QUERY, p_build=P_BUILD, levels=QSRP_LEVELS,
                   qsrp_block=QSRP_BLOCK):
    """Phase 8: row-sharded execution and the QSRP baseline, P shards on
    one device (`distributed.flat_mesh((dev,) * P)`), each check fatal.

    `users`, `items`, `cfg`, `pos`, `w`, `qs`, `rt` are phase 4's (its
    f32 table), `int8` phase 4b's (stored users, rank table), `truth` /
    `exact_idx` phase 4's oracle (K3 ranks and reverse_k_ranks of each
    query), `mid` phase 4c (iii)'s mid_mixture (users, items) draw and
    `qs_hot` its hot-cluster batch; `q1` the B = 1 query (qs[0]).

      (a) the sharded query at n over `p_query` shards, at f32 and int8,
          B = len(qs) and 1: indices, est_rank, R_k and guaranteed
          bitwise `select_topk` over the concatenated shards' own
          bounds; against the single-device dense path R↓_k, R↑_k equal
          and at least k - 1 shared indices a query (the bound cells
          that differ are printed); one step of each cross-shard
          collective a call; `build_index` on n and m takes the dense
          fallback, bitwise phase 4's table;
      (b) `build_sharded` on the first `n_cut` users over `p_build`
          shards at f32 and int8 against `build_rank_table` on the same
          rows: rows with bitwise thresholds have bitwise table rows,
          every row within rtol/atol 1e-5, the int8 pack bitwise
          `pack_table` of the sharded f32 rows; K2 launched P times
          against once, each in a window of its own;
      (c) pruned:sharded (forced, max_union_frac=1.0) on the mid_mixture
          draw cut to `n_cut`, reordered, built sharded: indices and R_k
          bitwise the unpruned sharded query on the same table; at n the
          `align` fallback (over `p_query` shards: n is odd);
      (d) `ring_exact_ranks` on the cut users for every query, bitwise
          phase 4's exact ranks of those users; p_build² K3 launches a
          query;
      (e) QSRP at n: `build_qsrp_index(levels)` (time, peak memory above
          what was held, bytes); `qsrp_query` for every query at c = 1
          and 2: each returned rank bitwise the exact rank, accuracy 1
          against phase 4's oracle with the reference's one-rank tie
          slack, n_refined not growing with c.

    On the CPU (a rehearsal) the launch counts and peak memory are not
    read. Returns {"checks", "digest"}."""
    import numpy as np
    import torch
    from repro_torch.core import distributed as D
    from repro_torch.core import qsrp as QS
    from repro_torch.core import query as query_mod
    from repro_torch.core import rank_table as rt_mod
    from repro_torch.core.backends import PrunedBackend, ShardedBackend
    from repro_torch.core.engine import ReverseKRanksEngine
    from repro_torch.core.types import RankTable, RankTableConfig
    from repro_torch.kernels import ops
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    n, m = users.shape[0], items.shape[0]
    nq = qs.shape[0]
    q1 = qs[0] if q1 is None else q1
    mesh_q = D.flat_mesh((dev,) * p_query)
    mesh_b = D.flat_mesh((dev,) * p_build)
    checks = []

    def clock(fn):
        """(fn(), host ms), synchronized with the device."""
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    def spec_cfg(spec):
        return cfg if spec == "f32" else RankTableConfig(
            tau=cfg.tau, omega=cfg.omega, s=cfg.s, storage_dtype=spec)

    # (a) the sharded query at n over p_query shards of the device
    digest = None
    for spec, rt_s in (("f32", rt), ("int8", int8[1])):
        eng = ReverseKRanksEngine(users, rt_s, spec_cfg(spec),
                                  backend="sharded", mesh=mesh_q)
        u = eng.current_snapshot().query_users()
        if spec == "int8":
            check(all(torch.equal(a, b) for a, b in zip(u, int8[0])
                      if a is not None),
                  "(a) int8: the engine's stored users differ from phase "
                  "4b's")
        D.reset_collective_counts()
        res, t_b = clock(lambda: eng.query_batch(qs, K, C))
        coll = dict(D.COLLECTIVES)
        res1, t_1 = clock(lambda: eng.query(q1, K, C))
        label = f"(a) {spec} sharded P={p_query}"
        check(all(v == 1 for v in coll.values()),
              f"{label}: collectives {coll}, expected one step each")
        check(res.r_lo.shape == (nq, K * p_query)
              and res.indices.shape == (nq, K),
              f"{label}: result shapes {tuple(res.r_lo.shape)}, "
              f"{tuple(res.indices.shape)}")
        bounds = D.shard_bounds(mesh_q, rt_s, u, qs)
        merged = query_mod.select_topk(*bounds, k=K, c=C, m_items=m)
        bounds1 = D.shard_bounds(mesh_q, rt_s, u, q1[None, :])
        merged1 = query_mod.squeeze_result(query_mod.select_topk(
            *bounds1, k=K, c=C, m_items=m))
        for f in ("indices", "est_rank", "R_lo_k", "R_up_k", "guaranteed"):
            check(torch.equal(getattr(res, f), getattr(merged, f)),
                  f"{label}: {f} differs from select_topk over the "
                  "concatenated shard bounds")
            check(torch.equal(getattr(res1, f), getattr(merged1, f)),
                  f"{label}: query(q) {f} differs from select_topk over "
                  "the shard bounds")
        dense_b = query_mod.bound_ranks_batch(rt_s, u, qs)
        res_d = query_mod.select_topk(*dense_b, k=K, c=C, m_items=m)
        cells = sum(int((a != b).sum()) for a, b in zip(bounds, dense_b))
        check(torch.equal(res.R_lo_k, res_d.R_lo_k)
              and torch.equal(res.R_up_k, res_d.R_up_k),
              f"{label}: R_lo_k / R_up_k differ from the single-device "
              "dense path")
        shared = [len(set(res.indices[b].tolist())
                      & set(res_d.indices[b].tolist())) for b in range(nq)]
        check(min(shared) >= K - 1, f"{label}: shared indices with the "
              f"dense path {shared}, need >= {K - 1} a query")
        print(f"  {label}: query_batch(B={nq}) {t_b:.3f} ms, query "
              f"{t_1:.3f} ms (host, synced, first calls); collectives "
              f"{coll}; indices, est_rank, R_k, guaranteed bitwise "
              f"select_topk over the shards' own bounds; against the "
              f"dense path R_k equal, shared indices min {min(shared)} of "
              f"{K}, {cells} of {3 * nq * n} bound cells differ")
        if cuda:
            steady = time_ms(torch, lambda: eng.query_batch(qs, K, C),
                             reps=10)
            steady_1 = time_ms(torch, lambda: eng.query(q1, K, C), reps=10)
            dense_t = time_ms(torch, lambda: query_mod.query_batch(
                rt_s, u, qs, K, C), reps=10)
            print(f"  {label}: steady query_batch {steady:.3f} ms, query "
                  f"{steady_1:.3f} ms (CUDA events, 10 calls); the "
                  f"single-device dense query_batch {dense_t:.3f} ms")
            print(f"  {label}: profile of query_batch: " + device_breakdown(
                torch, lambda: eng.query_batch(qs, K, C)))
        if spec == "f32":
            digest = sharded_digest(torch, res)
        del eng, u, res, res1, bounds, merged, dense_b, res_d
    bk = ShardedBackend(mesh_q)
    rt_fb, t_fb = clock(lambda: bk.build_index(users, items, cfg,
                                               positions=pos, weights=w))
    check(bk.build_fallback == "shape", f"(a) build_index at n={n}, m={m}, "
          f"P={p_query}: fallback {bk.build_fallback!r}, expected 'shape'")
    check(torch.equal(rt_fb.table, rt.table)
          and torch.equal(rt_fb.thresholds, rt.thresholds),
          "(a) the dense fallback build differs from phase 4's table")
    print(f"  (a) build_index at n={n}, m={m} over {p_query} shards: m % "
          f"{p_query} = {m % p_query}, the dense fallback "
          f"(build_fallback={bk.build_fallback!r}) in {t_fb:.1f} ms, "
          "bitwise phase 4's table")
    del rt_fb, bk
    checks.append("a")

    # (b) the sharded build on the first n_cut users over p_build shards
    u_c = users[:n_cut]
    same = None
    for spec in ("f32", "int8"):
        cfg_s = spec_cfg(spec)
        ops.reset_launch_counts()
        rt_sh, t_sh = clock(lambda: D.build_sharded(u_c, items, cfg_s, pos,
                                                    w, mesh_b))
        k2_sh = ops.LAUNCHES["k2_table_build"]
        ops.reset_launch_counts()
        rt_1, t_one = clock(lambda: rt_mod.build_rank_table(
            u_c, items, cfg_s, positions=pos, weights=w))
        k2_one = ops.LAUNCHES["k2_table_build"]
        label = f"(b) {spec} build_sharded n'={n_cut} P={p_build}"
        if cuda:
            check(k2_one == 1 and k2_sh == p_build * k2_one,
                  f"{label}: K2 launches {k2_sh} sharded, {k2_one} single")
        if spec == "f32":
            same_thr = (rt_sh.thresholds == rt_1.thresholds).all(dim=1)
            same_tab = (rt_sh.table == rt_1.table).all(dim=1)
            check(bool((same_tab | ~same_thr).all()),
                  f"{label}: a row with bitwise thresholds has a table row "
                  "that differs (K2 is row-local)")
            check(torch.allclose(rt_sh.thresholds, rt_1.thresholds,
                                 rtol=1e-5, atol=1e-5)
                  and torch.allclose(rt_sh.table, rt_1.table, rtol=1e-5,
                                     atol=1e-5),
                  f"{label}: rows beyond rtol/atol 1e-5 of the single "
                  "build")
            same = same_thr & same_tab
            f32_sh = rt_sh
            detail = (f"{int((~same_thr).sum())} rows' thresholds and "
                      f"{int((~same_tab).sum())} rows' table differ from "
                      "the single build, all within 1e-5; rows with "
                      "bitwise thresholds have bitwise table rows")
        else:
            packed = cfg_s.storage.pack_table(f32_sh.thresholds,
                                              f32_sh.table, m=m)
            for f in RankTable._fields:
                a, b = getattr(rt_sh, f), getattr(packed, f)
                check(a == b if f == "m" else torch.equal(a, b),
                      f"{label}: {f} is not pack_table of the sharded f32 "
                      "rows")
                if f != "m":
                    eq = (a == getattr(rt_1, f)).all(dim=1)
                    check(bool((eq | ~same).all()),
                          f"{label}: {f} differs from the single build on "
                          "a row whose f32 rows are bitwise equal")
            detail = ("pack_table of the sharded f32 rows bitwise; rows "
                      "whose f32 rows match bitwise the single build's")
        print(f"  {label}: {t_sh:.1f} ms sharded ({k2_sh} K2 launches) "
              f"against {t_one:.1f} ms single ({k2_one}); {detail}")
        del rt_1
        if spec == "int8":
            del rt_sh, f32_sh, packed
    checks.append("b")

    # (c) pruned:sharded on the mid_mixture draw cut to n_cut
    mu, mi = mid
    gm = torch.Generator(device=dev)
    gm.manual_seed(6)
    eng_p, t_bp = clock(lambda: ReverseKRanksEngine.build(
        mu[:n_cut], mi, cfg, gm, backend=PrunedBackend(
            "sharded", mesh=mesh_b, max_union_frac=1.0),
        device=dev, cluster_reorder=True))
    check(eng_p._backend.inner.build_fallback == "",
          f"(c) the pruned engine's build fell back "
          f"({eng_p._backend.inner.build_fallback!r})")
    res_p, t_p = clock(lambda: eng_p.query_batch(qs_hot, K, C))
    st = eng_p._backend.stats
    check(st.fallback == "", f"(c) pruned:sharded fell back ({st.fallback})")
    unp = ReverseKRanksEngine(eng_p.users, eng_p.rank_table, cfg,
                              backend="sharded", mesh=mesh_b)
    res_u = unp.query_batch(qs_hot, K, C)
    for f in ("indices", "R_lo_k", "R_up_k"):
        check(torch.equal(getattr(res_p, f), getattr(res_u, f)),
              f"(c) pruned:sharded {f} differs from the unpruned sharded "
              "query on the same table")
    line = (f"  (c) pruned:sharded n'={n_cut} P={p_build} (mid_mixture, "
            f"reordered, built sharded in {t_bp:.1f} ms): kept union "
            f"{st.kept_union} of {st.n_blocks} blocks, skip rate "
            f"{st.skip_rate:.4f}; indices, R_k bitwise the unpruned sharded "
            f"query; first query_batch {t_p:.3f} ms")
    if cuda:
        t_sp = time_ms(torch, lambda: eng_p.query_batch(qs_hot, K, C),
                       reps=10)
        t_su = time_ms(torch, lambda: unp.query_batch(qs_hot, K, C), reps=10)
        line += f"; steady {t_sp:.3f} ms, unpruned {t_su:.3f} ms"
    print(line)
    del eng_p, unp, res_p, res_u
    eng_a = ReverseKRanksEngine(users, rt, cfg, backend=PrunedBackend(
        "sharded", mesh=mesh_q))
    res_a = eng_a.query_batch(qs, K, C)
    st = eng_a._backend.stats
    check(st.fallback == "align", f"(c) at n={n} over {p_query} shards the "
          f"pruned path did not take the align fallback ({st.fallback!r})")
    same_result(torch, res_a, ReverseKRanksEngine(
        users, rt, cfg, backend="sharded", mesh=mesh_q).query_batch(
            qs, K, C), "(c) the align fallback")
    print(f"  (c) at n={n} over {p_query} shards (n % {p_query * 256} = "
          f"{n % (p_query * 256)}): stats.fallback={st.fallback!r}, the "
          "result bitwise the unpruned sharded query's")
    del eng_a, res_a
    checks.append("c")

    # (d) the ring exact ranks on the cut users
    ops.reset_launch_counts()
    rings, t_r = clock(lambda: [D.ring_exact_ranks(u_c, items, qs[b], mesh_b)
                                for b in range(nq)])
    k3 = ops.LAUNCHES["k3_exact_ranks"]
    if cuda:
        check(k3 == p_build ** 2 * nq, f"(d) K3 launches {k3}, expected "
              f"{p_build ** 2} a query")
    for b in range(nq):
        check(rings[b].dtype == torch.float32 and torch.equal(
            rings[b], truth[b][:n_cut].to(torch.float32)),
            f"(d) ring_exact_ranks of query {b} differs from the exact "
            "ranks")
    print(f"  (d) ring_exact_ranks n'={n_cut} P={p_build}: {nq} queries in "
          f"{t_r:.1f} ms ({k3} K3 launches), bitwise phase 4's exact "
          "ranks of those users")
    del rings
    checks.append("d")

    # (e) the QSRP baseline at n
    if cuda:
        sync()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
    idx, t_q = clock(lambda: QS.build_qsrp_index(users, items, levels=levels,
                                                 block=qsrp_block))
    nbytes = (idx.quantile_scores.numel() * 4
              + idx.ranks_at.numel() * idx.ranks_at.element_size())
    peak = (f"{(torch.cuda.max_memory_allocated(dev) - held) / 1e9:.3f} GB "
            f"above the {held / 1e9:.3f} GB held") if cuda else "n/a"
    print(f"  (e) build_qsrp_index(levels={levels}, block={qsrp_block}) at "
          f"n={n}, m={m}: {t_q / 1e3:.3f} s, {nbytes} bytes, peak {peak}")
    refined = {}
    for c in (1.0, 2.0):
        ops.reset_launch_counts()
        times = []
        refined[c] = []
        for b in range(nq):
            (got, ranks, nref), t = clock(lambda: QS.qsrp_query(
                idx, users, items, qs[b], K, c))
            times.append(t)
            refined[c].append(nref)
            tr = truth[b].cpu().numpy()
            check(np.array_equal(np.asarray(ranks, np.float64),
                                 tr[got].astype(np.float64)),
                  f"(e) c={c} query {b}: QSRP's ranks differ from the exact "
                  "ranks")
            ours = np.sort(tr[got]).astype(np.float64)
            ex = np.sort(tr[exact_idx[b].cpu().numpy()]).astype(np.float64)
            check(len(got) == K and bool(np.all(ours <= c * ex + 1)),
                  f"(e) c={c} query {b}: accuracy below 1 ({ours} against "
                  f"{ex})")
        print(f"  (e) qsrp_query c={c}: {nq} queries, accuracy 1, ranks "
              f"exact; online {sum(times) / nq:.3f} ms a query (host, "
              f"synced; first {times[0]:.3f}, min {min(times):.3f}); "
              f"refined users {refined[c]}; "
              f"{ops.LAUNCHES['k3_exact_ranks']} K3 launches")
    check(all(a >= b for a, b in zip(refined[1.0], refined[2.0])),
          f"(e) n_refined grows with c: {refined}")
    if cuda:
        worst = int(np.argmax(refined[1.0]))
        print(f"  (e) profile of qsrp_query c=1.0 on query {worst} "
              f"({refined[1.0][worst]} users refined): " + device_breakdown(
                  torch, lambda: QS.qsrp_query(idx, users, items, qs[worst],
                                               K, 1.0)))
    del idx
    checks.append("e")
    return {"checks": checks, "digest": digest}


# ------------------------------------------------------- 9. entry points
NETFLIX_RATINGS = 100_480_507      # the Netflix Prize's ratings, (e)
MF_EPOCHS = 2                      # (e)'s --mf-epochs
MF_CHECK_RATINGS = 10_000_000      # (e)'s determinism check, one epoch
SERVE_QUERIES = 512                # (a), (b) and (c)'s --queries
CHURN_REBUILD_RATIO = 0.01         # (c): a rebuild every ~15 update batches
LONG_QUERIES = 100_000             # (d)'s run, which SIGTERM stops
DRAIN_S = 2.0                      # (d)'s --drain-s
SPILL_S = 15.0                     # (d): an int8 spill and a rebuild's, s
EXAMPLES = ("quickstart", "ablation", "serve_retrieval")


def index_bytes(spec: str, n: int, d: int, tau: int) -> int:
    """`memory_bytes()` of a static index, as phases 4 and 4b read it:
    at f32 the thresholds, the table and the users; at int8 their codes,
    the five per-row f32 vectors, the stored rows, scale and slack."""
    if spec == "f32":
        return n * (8 * tau + 4 * d)
    return n * (2 * tau + d + 28)


class Lines:
    """The lines a running process prints, read by threads of their own,
    so that every wait on them is bounded."""

    def __init__(self, proc):
        import threading
        self.proc = proc
        self.out, self.err = [], []
        self._cond = threading.Condition()
        self._threads = [threading.Thread(target=self._read, args=(f, buf),
                                          daemon=True)
                         for f, buf in ((proc.stdout, self.out),
                                        (proc.stderr, self.err))]
        for t in self._threads:
            t.start()

    def _read(self, f, buf) -> None:
        for line in f:
            with self._cond:
                buf.append(line)
                self._cond.notify_all()
        with self._cond:
            self._cond.notify_all()

    def wait_for(self, pattern: str, timeout: float) -> str:
        """The first stdout line matching `pattern`; fails at the timeout
        or when the process has ended without one."""
        import re
        rx, seen = re.compile(pattern), 0
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                ended = not any(t.is_alive() for t in self._threads)
                for line in self.out[seen:]:
                    if rx.search(line):
                        return line
                seen = len(self.out)
                left = deadline - time.monotonic()
                check(left > 0 and not ended,
                      f"no line matching {pattern!r} before the process "
                      f"{'ended' if ended else 'timed out'} (stderr: "
                      f"{''.join(self.err)[-3000:]})")
                self._cond.wait(timeout=min(left, 0.5))

    def finish(self, timeout: float) -> tuple:
        """Wait for the process (killed past `timeout`); (rc, out, err)."""
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=60)
            raise SmokeFailure(f"still running after {timeout} s: "
                               f"{''.join(self.out)[-3000:]}")
        finally:
            for t in self._threads:
                t.join(timeout=60)
        return rc, "".join(self.out), "".join(self.err)


def entry_start(args) -> Lines:
    """Start one entry point under the import blocker."""
    return Lines(run_blocked(*args, timeout=None, popen=True))


def entry_finish(label: str, lines: Lines, t0: float, timeout: float
                 ) -> tuple:
    """Wait for a started entry point; fail on a non-zero exit, an import
    of JAX or the reference, or a rebuilt kernel. Prints its wall time
    (since `t0`), launches, peak device memory and its lines (not the
    periodic stats lines). Returns (stdout, runner record, wall s)."""
    rc, out, err = lines.finish(timeout)
    wall = time.perf_counter() - t0
    if rc != 0:
        print(out[-6000:])
        print(err[-6000:], file=sys.stderr)
    check(rc == 0, f"({label}) exit {rc}")
    return out, entry_report(label, out, wall), wall


def entry_run(label: str, args, timeout: float) -> tuple:
    """`entry_start` then `entry_finish`."""
    return entry_finish(label, entry_start(args), time.perf_counter(),
                        timeout)


def entry_report(label: str, stdout: str, wall: float) -> dict:
    rep = runner_report(stdout)
    check(not rep["leaked"], f"({label}) imported {rep['leaked']}")
    check(all(v == 0.0 for v in rep["built_s"].values()),
          f"({label}) built a kernel again: {rep['built_s']}")
    peak = rep["peak_bytes"]
    print(f"  ({label}) {wall:.1f} s wall; launches {rep['launches']}; "
          f"peak device memory "
          f"{'n/a' if peak is None else f'{peak / 1e9:.2f} GB'}")
    for line in stdout.splitlines():
        if not line.startswith(("runner: ", "  [")):
            print(f"    | {line}")
    return rep


def parse(pattern: str, stdout: str, label: str):
    import re
    m = re.search(pattern, stdout, re.M)
    check(m is not None, f"({label}) no line matching {pattern!r}")
    return m


def graded(stdout: str, label: str) -> tuple:
    """The accuracy line's numbers, each checked: accuracy in [0, 1], the
    overall ratio finite and ≥ 1."""
    m = parse(r"^accuracy (\S+)  overall-ratio (\S+)", stdout, label)
    acc, ratio = float(m.group(1)), float(m.group(2))
    check(0.0 <= acc <= 1.0 and math.isfinite(ratio) and ratio >= 1.0,
          f"({label}) accuracy {acc}, overall ratio {ratio}")
    return acc, ratio


def index_mib(stdout: str, label: str, want_bytes: int) -> float:
    got = float(parse(r"^build: \S+s  index (\S+) MiB", stdout,
                      label).group(1))
    check(abs(got - want_bytes / 2**20) <= 0.1,
          f"({label}) index {got} MiB, expected {want_bytes / 2**20:.1f}")
    return got


def launched(rep: dict, label: str, name: str, *, exactly=None) -> int:
    """A kernel's launches in a run on the card: at least one, or exactly
    `exactly`."""
    got = rep["launches"].get(name, 0)
    ok = got >= 1 if exactly is None else got == exactly
    check(ok, f"({label}) {name} launched {got} times"
          + ("" if exactly is None else f", expected {exactly}"))
    return got


def entry_point_checks(dev, *, n=N, m=M, d=D, tau=TAU,
                       queries=SERVE_QUERIES, long_queries=LONG_QUERIES,
                       n_ratings=NETFLIX_RATINGS, mf_epochs=MF_EPOCHS,
                       mf_check_ratings=MF_CHECK_RATINGS, examples=None,
                       timeout=600.0) -> dict:
    """Phase 9: the port's entry points as a user runs them, each in a
    subprocess under the import blocker (`run_blocked`), at the sizes
    given (Netflix's by default) on `dev` (the card, or the CPU for a
    rehearsal: then `--device cpu` is passed and launch counts, which
    only the card's wrappers make, are not checked).

      (a) `launch.serve --backend fused`: exit 0, the f32 index bytes,
          every query served, the latency histogram's count = served,
          K2/K1/K3 launched (K3 once a graded query);
      (b) `--storage int8 --backend elastic:fused --pipeline-depth 2`:
          the int8 index bytes, `query_compiled_programs` ≤ 1 (one
          capacity bucket at this n, one padded tick shape);
      (c) the same with `--update-stream --persist-dir --audit-fraction
          0.05`: ≥ 1 rebuild, ≥ 2 epochs served, ≥ 1 audited sample; then
          `ReverseKRanksEngine.restore` here holds m + 4·b live items for
          the b update batches the flags imply;
      (d) a long int8 run with `--update-stream --persist-dir
          --metrics-port 0`: `/metrics` scraped after the first stats line
          holds `serve_request_latency_ms`; SIGTERM, then exit 0 within
          the drain bound plus a spill, `shutdown complete`; `restore` of
          its directory holds more than m live items, m mod 4;
      (e) `--mf` at `n_ratings`: the MF loss falls, the engine runs at
          d + 2 (its f32 index bytes); here, two trainings of one epoch
          at `mf_check_ratings` are bitwise equal, an epoch's replayed
          CUDA graph is bitwise its steps launched one by one, and
          `synthetic_ratings` computed in one chunk is bitwise the
          chunked one;
      (f) the examples, each run as `python -m` (on the card, at their
          reference sizes) or through `examples` = {name: statement},
          their three processes at once (each one's wall time is from
          the common start).
    """
    import shutil
    import signal
    import tempfile
    import urllib.request
    import torch
    from repro_torch.core.engine import ReverseKRanksEngine
    from repro_torch.data.mf import MFConfig, init_mf, mf_epoch, train_mf
    from repro_torch.data.pipeline import synthetic_ratings
    cuda = dev.type == "cuda"
    serve = "repro_torch.launch.serve"
    size = ["--n", str(n), "--m", str(m), "--d", str(d), "--tau", str(tau)]
    if not cuda:
        size += ["--device", "cpu"]
    tmp = tempfile.mkdtemp(prefix="entry-")
    checks, times = [], {}
    try:
        # (a) plain serving, f32 fused
        mj = os.path.join(tmp, "a.json")
        out, rep, times["a"] = entry_run("a", [
            serve, *size, "--backend", "fused", "--queries", str(queries),
            "--max-batch", "16", "--metrics-json", mj], timeout)
        index_mib(out, "a", index_bytes("f32", n, d, tau))
        served = int(parse(r"^  ticks: (\d+) reqs", out, "a").group(1))
        check(served == queries, f"(a) served {served} of {queries}")
        with open(mj) as f:
            snap = json.load(f)["metrics"]
        lat = snap["serve_request_latency_ms"][0]["count"]
        check(lat == served, f"(a) latency histogram count {lat}, served "
              f"{served}")
        acc, ratio = graded(out, "a")
        if cuda:
            launched(rep, "a", "k2_table_build", exactly=1)
            launched(rep, "a", "k1_bound_ranks")
            launched(rep, "a", "k3_exact_ranks", exactly=min(queries, 20))
        print(f"  (a) {served} served, latency count {lat}, accuracy {acc}, "
              f"overall ratio {ratio}")
        checks.append("a")

        # (b) the int8 tier behind elastic serving
        mj = os.path.join(tmp, "b.json")
        out, rep, times["b"] = entry_run("b", [
            serve, *size, "--storage", "int8", "--backend", "elastic:fused",
            "--pipeline-depth", "2", "--queries", str(queries),
            "--max-batch", "16", "--metrics-json", mj], timeout)
        index_mib(out, "b", index_bytes("int8", n, d, tau))
        with open(mj) as f:
            snap = json.load(f)["metrics"]
        progs = snap["query_compiled_programs"][0]["value"]
        check(progs <= 1, f"(b) {progs} programs for one (capacity bucket, "
              "tick shape) pair")
        acc, ratio = graded(out, "b")
        if cuda:
            launched(rep, "b", "k2_table_build")
            launched(rep, "b", "k5_bound_ranks_int8_elastic")
            launched(rep, "b", "k3_exact_ranks", exactly=min(queries, 20))
        print(f"  (b) query_compiled_programs {progs:g}; accuracy {acc}, "
              f"overall ratio {ratio}")
        checks.append("b")

        # (c) churn, durability and the auditor
        pd = os.path.join(tmp, "c")
        out, rep, times["c"] = entry_run("c", [
            serve, *size, "--storage", "int8", "--backend", "elastic:fused",
            "--queries", str(queries), "--max-batch", "16",
            "--update-stream", "--rebuild-delta-ratio",
            str(CHURN_REBUILD_RATIO), "--persist-dir", pd,
            "--audit-fraction", "0.05", "--stats-every", "256"], timeout)
        mu = parse(r"update stream: final epoch (\d+), (\d+) rebuild\(s\), "
                   r"epochs served \[(.*?)\]", out, "c")
        rebuilds, served_epochs = int(mu.group(2)), mu.group(3).split(",")
        check(rebuilds >= 1, "(c) the maintenance loop never rebuilt")
        check(len(served_epochs) >= 2, f"(c) epochs served {served_epochs}")
        scored = int(parse(r"audit: (\d+) scored", out, "c").group(1))
        check(scored >= 1, "(c) the auditor scored nothing")
        graded(out, "c")
        if cuda:
            launched(rep, "c", "k2_table_build")
            launched(rep, "c", "k5_bound_ranks_int8_elastic")
            launched(rep, "c", "k3_exact_ranks",
                     exactly=scored + min(queries, 20))
        batches = (queries - 1) // 16
        t0 = time.perf_counter()
        eng = ReverseKRanksEngine.restore(pd, backend="fused", device=dev)
        t_restore = time.perf_counter() - t0
        live = eng.live_item_ids().size
        check(live == m + (8 - 4) * batches,
              f"(c) restored {live} live items, expected "
              f"{m + 4 * batches} ({batches} update batches)")
        check(eng.epoch == int(mu.group(1)),
              f"(c) restored epoch {eng.epoch}, served {mu.group(1)}")
        del eng
        print(f"  (c) {rebuilds} rebuild(s), {len(served_epochs)} epochs "
              f"served, {scored} audited; restore {t_restore:.2f} s: "
              f"epoch {mu.group(1)}, {live} live items = {m} + 4·{batches}")
        checks.append("c")

        # (d) graceful shutdown and the metrics endpoint
        pd = os.path.join(tmp, "d")
        t0 = time.perf_counter()
        lines = entry_start([
            serve, *size, "--storage", "int8", "--backend", "elastic:fused",
            "--queries", str(long_queries), "--max-batch", "16",
            "--update-stream", "--persist-dir", pd, "--metrics-port", "0",
            "--stats-every", "256", "--drain-s", str(DRAIN_S)])
        try:
            url = lines.wait_for(r"^metrics: http://", timeout).split()[1]
            lines.wait_for(r"^  \[256/", timeout)
            with urllib.request.urlopen(url, timeout=60) as resp:
                text = resp.read().decode()
            check("serve_request_latency_ms" in text,
                  "(d) /metrics lacks serve_request_latency_ms")
            t_sig = time.perf_counter()
            lines.proc.send_signal(signal.SIGTERM)
        except BaseException:
            lines.proc.kill()
            lines.proc.wait(timeout=60)
            raise
        out, rep, times["d"] = entry_finish("d", lines, t0, timeout)
        t_exit = time.perf_counter() - t_sig
        check("shutdown complete" in out, "(d) no `shutdown complete`")
        check(t_exit <= DRAIN_S + SPILL_S,
              f"(d) exited {t_exit:.1f} s after SIGTERM")
        if cuda:
            launched(rep, "d", "k5_bound_ranks_int8_elastic")
        t0 = time.perf_counter()
        eng = ReverseKRanksEngine.restore(pd, backend="fused", device=dev)
        t_restore = time.perf_counter() - t0
        live = eng.live_item_ids().size
        check(live > m and (live - m) % 4 == 0,
              f"(d) restored {live} live items")
        del eng
        print(f"  (d) /metrics scraped ({len(text)} bytes); exit 0 "
              f"{t_exit:.2f} s after SIGTERM (drain bound {DRAIN_S} s); "
              f"restore {t_restore:.2f} s: {live} live items")
        checks.append("d")

        # (e) MF embeddings at the Netflix Prize's rating count
        out, rep, times["e"] = entry_run("e", [
            serve, *size, "--mf", "--n-ratings", str(n_ratings),
            "--mf-epochs", str(mf_epochs), "--backend", "fused",
            "--queries", "64"], timeout)
        mm = parse(r"^  MF: (\d+) epoch\(s\) of (\S+) steps in (\S+)s "
                   r"\((\S+) s/epoch\); losses \[(.*)\]$", out, "e")
        losses = [float(x) for x in mm.group(5).split(",")]
        check(len(losses) == mf_epochs and all(map(math.isfinite, losses)),
              f"(e) losses {losses}")
        check(mf_epochs < 2 or losses[-1] < losses[0],
              f"(e) the MF loss did not fall: {losses}")
        index_mib(out, "e", index_bytes("f32", n, d + 2, tau))
        graded(out, "e")
        if cuda:
            launched(rep, "e", "k2_table_build", exactly=1)
            launched(rep, "e", "k1_bound_ranks")
            launched(rep, "e", "k3_exact_ranks", exactly=20)
        print(f"  (e) {mm.group(1)} epoch(s) of {mm.group(2)} steps, "
              f"{mm.group(4)} s an epoch; losses {losses}; d = {d + 2}")
        ii, jj, rr = synthetic_ratings(0, n, m, mf_check_ratings, device=dev)
        _, _, whole = synthetic_ratings(0, n, m, mf_check_ratings,
                                        device=dev, chunk=mf_check_ratings)
        check(torch.equal(rr, whole),
              "(e) chunked synthetic_ratings differ from one chunk")
        cfg = MFConfig(d=d, epochs=1)
        states, t_mf = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            states.append(train_mf(0, n, m, ii, jj, rr, cfg, device=dev)[0])
            t_mf.append(time.perf_counter() - t0)
        check(all(torch.equal(states[0][k], states[1][k])
                  for k in states[0]),
              "(e) two trainings of one epoch differ")
        # the replayed graph's epoch against its steps launched one by one
        init = init_mf(0, n, m, cfg, device=dev)
        perm = torch.randperm(mf_check_ratings, device=dev)
        t0 = time.perf_counter()
        eager, _ = mf_epoch(init, ii, jj, rr, perm, cfg, graph=False)
        t_eager = time.perf_counter() - t0
        replayed, _ = mf_epoch(init, ii, jj, rr, perm, cfg)
        check(all(torch.equal(eager[k], replayed[k]) for k in eager),
              "(e) the graph's epoch differs from the eager steps'")
        del ii, jj, rr, whole, states, init, eager, replayed
        print(f"  (e) two trainings at {mf_check_ratings:,} ratings, one "
              f"epoch of {mf_check_ratings // cfg.batch:,} steps: bitwise "
              f"equal ({t_mf[0]:.2f} / {t_mf[1]:.2f} s); an epoch of "
              f"eager steps bitwise the graph's ({t_eager:.2f} s); chunked "
              "ratings bitwise one chunk")
        checks.append("e")

        # (f) the examples, their three processes at once
        t0 = time.perf_counter()
        runs = {name: entry_start(
            [f"repro_torch.examples.{name}"] if examples is None
            else ["-c", examples[name]]) for name in EXAMPLES}
        try:
            for name, lines in runs.items():
                out, rep, _ = entry_finish(f"f {name}", lines, t0, timeout)
                check("acc" in out, f"(f) {name} printed no grades")
                if cuda:
                    launched(rep, f"f {name}", "k2_table_build")
                    launched(rep, f"f {name}", "k3_exact_ranks")
        finally:
            for lines in runs.values():
                if lines.proc.poll() is None:
                    lines.proc.kill()
                    lines.proc.wait(timeout=60)
        times["f"] = time.perf_counter() - t0
        checks.append("f")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("  phase 9 wall times (s): " + ", ".join(
        f"({k}) {v:.1f}" for k, v in times.items()))
    return {"checks": checks, "times": times}


# ------------------------------------------------------------ main path
# ----------------------------------------------------- phase 10: the LM
LM_SEED = 29                       # phase 10's parameters and tokens
LM_PREFILL = (8, 2048)             # (a): prompts, tokens each (> chunk)
LM_DECODE = 32                     # (a): greedy tokens after the forced ones
LM_FORCED = 64                     # teacher-forced tokens held to prefill
LM_SHORT = (2, 64)                 # (b): prompts, tokens each
LM_AGREE = 0.8                     # argmax agreement, the reference's
#                                    tests/test_models_smoke.py criterion
STEP4 = dict(n_users=32_768, n_items=4_096, batch=512)
STEP4_QUERIES = 16


def lm_sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def lm_memory_start(torch, dev) -> float:
    """Reset the peak; → the GB held before a step (0 on the CPU)."""
    if dev.type != "cuda":
        return 0.0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev) / 1e9


def lm_peak(torch, dev, held: float) -> str:
    if dev.type != "cuda":
        return "peak not measured (CPU)"
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    return (f"peak {peak:.2f} GB, {peak - held:.2f} above the {held:.2f} "
            f"held before it")


def lm_forced(torch, T, params, cfg, tokens, want, cache_len, enc=None):
    """Teacher-forced decode of tokens[:, :F] through a fresh cache of
    `cache_len` slots, held to the prefill logits `want` (B, F, V) f32:
    → (argmax agreement, largest |logit difference|, the cache, the
    last step's logits)."""
    B, F_ = want.shape[:2]
    cache = T.init_cache(cfg, B, cache_len, tokens.device)
    if enc is not None:
        cache = T.fill_cross_kv(params, cache, enc, cfg)
    same = torch.zeros((), dtype=torch.int64, device=tokens.device)
    diff = torch.zeros((), device=tokens.device)
    finite = torch.ones((), dtype=torch.bool, device=tokens.device)
    for t in range(F_):
        lg, cache = T.decode_step(params, cache, tokens[:, t:t + 1], cfg)
        lg = lg[:, 0].float()
        same += (lg.argmax(-1) == want[:, t].argmax(-1)).sum()
        diff = torch.maximum(diff, (lg - want[:, t]).abs().max())
        finite &= torch.isfinite(lg).all()
    check(bool(finite), f"{cfg.name}: non-finite decode logits")
    return int(same) / (B * F_), float(diff), cache, lg


def lm_arch(torch, T, cfg, dev, g, *, batch, seq, forced, label):
    """Prefill of `batch` random prompts of `seq` tokens and the
    teacher-forced decode of their first `forced` tokens (MoE with no
    capacity drops, then a prefill at the config's own capacity factor,
    finite), each printed; frees the model."""
    import dataclasses
    held = lm_memory_start(torch, dev)
    t0 = time.perf_counter()
    params = T.init_params(g, cfg, dev)
    n_params = sum(t.numel() for t in T.leaves(params))
    tokens = torch.randint(cfg.vocab, (batch, seq), generator=g, device=dev)
    frames = enc = None
    if cfg.family == "encdec":
        frames = torch.randn((batch, cfg.enc_seq, cfg.d_model), generator=g,
                             device=dev)
    lm_sync(torch, dev)
    init_s = time.perf_counter() - t0
    check_cfg = cfg
    if cfg.family == "moe":
        check_cfg = dataclasses.replace(cfg, capacity_factor=float(
            cfg.n_experts))
    t0 = time.perf_counter()
    logits = T.forward_logits(params, tokens, check_cfg, frames=frames)
    lm_sync(torch, dev)
    prefill_s = time.perf_counter() - t0
    check(logits.shape == (batch, seq, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"{label}: prefill logits of shape {tuple(logits.shape)}, or "
          "not finite")
    want = logits[:, :forced].float()
    del logits
    if frames is not None:
        enc = T.encode(params, frames, cfg)
    agree, diff, cache, _ = lm_forced(torch, T, params, check_cfg, tokens,
                                      want, seq + 2, enc)
    del cache, want
    check(agree >= LM_AGREE, f"{label}: argmax agreement of decode with "
          f"prefill {agree:.3f} < {LM_AGREE}")
    own = ""
    if cfg.family == "moe":
        lg = T.forward_logits(params, tokens, cfg, frames=frames)
        check(bool(torch.isfinite(lg).all()), f"{label}: prefill at the "
              f"capacity factor {cfg.capacity_factor} not finite")
        own = f"; prefill at capacity factor {cfg.capacity_factor} finite"
        del lg
    peak = lm_peak(torch, dev, held)
    del params, enc, frames
    print(f"  (b) {label}: {cfg.n_layers} layers"
          + (f" + {cfg.n_enc_layers} encoder" if cfg.family == "encdec"
             else "")
          + f" at d_model {cfg.d_model}, {n_params / 1e9:.3f} B parameters "
          f"(init {init_s:.2f} s); prefill {batch} x {seq} {prefill_s:.3f} "
          f"s; forced decode of {forced}: argmax agreement {agree:.4f}, "
          f"largest |logit difference| {diff:.4g}{own}; {peak}")


def lm_checks(dev, *, configs=None, prefill=LM_PREFILL, decode=LM_DECODE,
              forced=LM_FORCED, short=LM_SHORT, step4=None,
              queries=STEP4_QUERIES) -> dict:
    """Phase 10: the LM substrate's serving path (`repro_torch.models`)
    on `dev` (the card; the CPU for a rehearsal with `configs` reduced
    and small sizes):

      (a) gemma-2b at its published size (18 layers, d_model 2,048, 8
          heads of 256, one kv head, d_ff 16,384, vocab 256,000, tied):
          parameters from a seeded generator on the device, prefill of
          `prefill` = (B, S) random prompts (S = 2,048 takes the
          chunked attention), the teacher-forced decode of each prompt's
          first `forced` tokens through a cache of S + `decode` slots
          (argmax agreement with the prefill ≥ 0.8, the largest logit
          difference), then `decode` greedy tokens; tokens/s of the
          prefill, ms a decode step, peak memory;
      (b) each other architecture at full width and `reduced_depth`:
          prefill of `short` and the same teacher-forced check (MoE at
          capacity factor = n_experts, then finite at its own), each
          model freed before the next;
      (c) step 4 of `examples/serve_retrieval.py` with gemma-2b drawn
          again: `step4` = n_users / n_items sequences of 16 tokens, encoded
          `batch` at a time, the rank table built (K2), `queries` items
          answered one at a time (K1) and graded (K3, two launches a
          query); the launches of K1, K2 and K3 counted in that window,
          exactly.

    Returns the checks passed and (c)'s data for the kernel checks at
    d_model."""
    import torch
    from repro_torch.configs import ARCH_IDS, get_config, reduced_depth
    from repro_torch.core import exact as exact_mod
    from repro_torch.core import metrics
    from repro_torch.examples import serve_retrieval as SR
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    cuda = dev.type == "cuda"
    if configs is None:
        configs = {a: (get_config(a) if a == "gemma-2b"
                       else reduced_depth(get_config(a))) for a in ARCH_IDS}
    step4 = dict(STEP4, **(step4 or {}))
    g = torch.Generator(device=dev)
    g.manual_seed(LM_SEED)
    checks = []

    # (a) gemma-2b at its published size
    cfg = configs["gemma-2b"]
    B, S = prefill
    held = lm_memory_start(torch, dev)
    t0 = time.perf_counter()
    params = T.init_params(g, cfg, dev)
    lm_sync(torch, dev)
    n_params = sum(t.numel() for t in T.leaves(params))
    print(f"  (a) {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.hd}, {cfg.n_kv_heads} kv head, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}: {n_params:,} f32 "
          f"parameters in {time.perf_counter() - t0:.2f} s")
    prompts = torch.randint(cfg.vocab, (B, S), generator=g, device=dev)
    T.forward_logits(params, prompts[:1, :forced], cfg)   # library set-up
    lm_sync(torch, dev)
    t0 = time.perf_counter()
    logits = T.forward_logits(params, prompts, cfg)
    lm_sync(torch, dev)
    prefill_s = time.perf_counter() - t0
    check(logits.shape == (B, S, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          "(a) prefill logits of the wrong shape, or not finite")
    want = logits[:, :forced].float()
    del logits
    agree, diff, cache, last = lm_forced(torch, T, params, cfg, prompts,
                                         want, S + decode)
    del want
    check(agree >= LM_AGREE, f"(a) argmax agreement of decode with prefill "
          f"{agree:.4f} < {LM_AGREE}")
    tok = last.argmax(-1, keepdim=True)
    out_tokens = []
    lm_sync(torch, dev)
    t0 = time.perf_counter()
    for _ in range(decode):
        lg, cache = T.decode_step(params, cache, tok, cfg)
        tok = lg[:, 0].float().argmax(-1, keepdim=True)
        out_tokens.append(tok)
    lm_sync(torch, dev)
    step_ms = (time.perf_counter() - t0) * 1e3 / decode
    gen = torch.cat(out_tokens, 1)
    check(cache["len"] == forced + decode and bool(
        ((gen >= 0) & (gen < cfg.vocab)).all()),
          "(a) greedy decode: cache length or tokens out of range")
    del cache, gen, out_tokens
    peak = lm_peak(torch, dev, held)
    print(f"  (a) prefill {B} x {S}: {prefill_s:.3f} s, "
          f"{B * S / prefill_s:,.0f} tokens/s; forced decode of {forced} "
          f"(cache {S + decode}): argmax agreement {agree:.4f}, largest "
          f"|logit difference| {diff:.4g}; greedy decode {decode} tokens: "
          f"{step_ms:.2f} ms a step of {B} ({step_ms / B:.3f} ms a token); "
          f"{peak}")
    checks.append("a")

    # (b) the other architectures at full width, reduced depth; (c) draws
    # gemma-2b again
    del params
    for arch, acfg in configs.items():
        if arch != "gemma-2b":
            lm_arch(torch, T, acfg, dev, g, batch=short[0], seq=short[1],
                    forced=forced, label=arch)
    checks.append("b")

    # (c) step 4 of serve_retrieval with gemma-2b
    held = lm_memory_start(torch, dev)
    params = T.init_params(g, cfg, dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = SR.backbone_step(dev, cfg=cfg, params=params, **step4)
    users, items, eng = out["users"], out["items"], out["engine"]
    del params
    gq = torch.Generator(device=dev)
    gq.manual_seed(LM_SEED + 1)
    qids = torch.randperm(items.shape[0], generator=gq,
                          device=dev)[:queries].tolist()
    lm_sync(torch, dev)
    t1 = time.perf_counter()
    res = [eng.query(items[j], SR.SEQ_K, SR.SEQ_C) for j in qids]
    lm_sync(torch, dev)
    query_ms = (time.perf_counter() - t1) * 1e3 / queries
    accs, ratios = [], []
    for j, r in zip(qids, res):
        truth = exact_mod.exact_ranks(users, items, items[j])
        ex_idx, _ = exact_mod.reverse_k_ranks(users, items, items[j],
                                              SR.SEQ_K)
        got, ex, tr = (x.cpu().numpy() for x in (r.indices, ex_idx, truth))
        accs.append(metrics.accuracy(got, ex, tr, SR.SEQ_C))
        ratios.append(metrics.overall_ratio(got, ex, tr))
    lm_sync(torch, dev)
    counts = dict(ops.LAUNCHES)
    wall_c = time.perf_counter() - t0
    mean = lambda xs: sum(xs) / len(xs)
    for a, r in zip(accs, ratios):
        check(0.0 <= a <= 1.0 and r >= 1.0 and r == r,
              "(c) §5 metrics out of range")
    check(users.shape == (step4["n_users"], cfg.d_model)
          and items.shape == (step4["n_items"], cfg.d_model)
          and users.dtype == torch.float32
          and bool(torch.isfinite(users).all())
          and bool(torch.isfinite(items).all()),
          "(c) embeddings of the wrong shape or type, or not finite")
    if cuda:
        want_counts = {"k2_table_build": 1, "k1_bound_ranks": queries + 1,
                       "k3_exact_ranks": 2 * queries,
                       "select_kth": queries + 1,
                       "select_lemma1": queries + 1}
        got_counts = {k: v for k, v in counts.items() if v}
        check(got_counts == want_counts, f"(c) launches {got_counts}, "
              f"expected {want_counts}")
    print(f"  (c) step 4, {cfg.name} at d_model {cfg.d_model}: "
          f"{step4['n_users']} user and {step4['n_items']} item sequences "
          f"of {SR.SEQ_LEN} tokens, {step4['batch']} a batch: encode "
          f"{out['encode_s']:.2f} s, build {out['build_s']:.3f} s (tau "
          f"{SR.BACKBONE_TABLE.tau}, omega {SR.BACKBONE_TABLE.omega}, s "
          f"{SR.BACKBONE_TABLE.s}); {queries} queries (k={SR.SEQ_K}, "
          f"c={SR.SEQ_C}) {query_ms:.2f} ms each; §5 accuracy "
          f"{mean(accs):.4f}, overall ratio {mean(ratios):.4f}; launches "
          f"{ {k: v for k, v in counts.items() if v} }; {wall_c:.1f} s; "
          f"{lm_peak(torch, dev, held)}")
    checks.append("c")
    return {"checks": checks, "c": {"users": users, "items": items,
                                    "engine": eng, "qids": qids,
                                    "counts": counts}}


def lm_kernel_rows(torch, ops, ref, query_mod, c4) -> list:
    """Phase 10's kernels at gemma-2b's width: K1 (B = 1), K2 and K3 on
    step 4's embeddings, table and samples (`lm_checks`' (c) data `c4`),
    each against its plain version and timed beside its bound; their
    launches are (c)'s window's. → the kernels line's records."""
    src = "src/repro_torch/kernels/csrc/"
    rows = []
    u4, i4, eng4 = c4["users"], c4["items"], c4["engine"]
    n4, d4 = u4.shape
    m4 = i4.shape[0]
    thr4, tab4 = eng4.rank_table.thresholds, eng4.rank_table.table
    tau4 = thr4.shape[1]
    base4 = eng4.current_snapshot().base
    samples4, w4 = base4.samples, base4.weights
    s4 = samples4.shape[0]
    q4 = i4[c4["qids"][0]].contiguous()
    label = f"step 4 n={n4} m={m4} d={d4}"
    err = check_k1(torch, ops, ref, u4, q4[None], thr4, tab4, m4,
                   f"{label} B=1")
    ms = time_ms(torch, lambda: ops.bound_ranks_batched(
        u4, q4[None], thr4, tab4, m=m4), reps=20)
    pms = time_ms(torch, lambda: ref.ref_bound_ranks(
        u4, q4[None], thr4, tab4, m4), reps=5)
    idx = query_mod._bucketize(thr4, u4 @ q4[:, None])
    need = (4 * (n4 * d4 + d4) + n4 * search_bytes(4 * tau4, 1)
            + gather_bytes(torch, idx, tau4, 4) + 12 * n4)
    del idx
    rows.append(kernel_record(
        f"k1_bound_ranks[B=1,d={d4}]", "src/repro/kernels/user_scores.py:57",
        c4["counts"]["k1_bound_ranks"], err, ms, pms, need,
        2 * n4 * d4 + n4 * math.ceil(math.log2(tau4)),
        src + "user_scores.cu"))
    table4, err = check_k2(torch, ops, ref, u4, samples4, w4, thr4, label)
    check(torch.equal(table4, tab4), f"K2 {label}: a second launch differs "
          "from the build's table")
    del table4
    ms = time_ms(torch, lambda: ops.build_table_rows(u4, samples4, w4, thr4),
                 reps=5)
    pms = time_ms(torch, lambda: ref.ref_table_rows(u4, samples4, w4, thr4),
                  reps=1)
    rows.append(kernel_record(
        f"k2_table_build[d={d4}]", "src/repro/kernels/table_build.py:28",
        c4["counts"]["k2_table_build"], err, ms, pms,
        4 * (n4 * d4 + s4 * d4 + s4 + 2 * n4 * tau4), 2 * n4 * s4 * d4,
        src + "table_build.cu"))
    _, nd, err = check_k3(torch, ops, ref, u4, i4, q4, label)
    print(f"  K3 {label}: {nd} of {n4} ranks differ from the plain version, "
          f"all explained; max abs err {err}")
    ms = time_ms(torch, lambda: ops.exact_ranks(u4, i4, q4), reps=3)
    pms = time_ms(torch, lambda: ref.ref_exact_counts(u4, i4, q4), reps=3)
    rows.append(kernel_record(
        f"k3_exact_ranks[d={d4}]", "src/repro/kernels/exact_rank.py:25",
        c4["counts"]["k3_exact_ranks"], err, ms, pms,
        4 * (n4 * d4 + m4 * d4 + d4 + n4), 2 * n4 * m4 * d4,
        src + "exact_rank.cu"))
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    mm = matmul_ms(torch, u4, i4)
    print(f"  f32 product alone, not K3's function: torch.matmul of the "
          f"({n4}, {d4}) x ({d4}, {m4}) product, TF32 off, in user blocks "
          f"of 32,768, scores written, summed over the blocks: {mm:.3f} ms "
          f"({2 * n4 * m4 * d4 / mm / 1e9:.1f} TFLOP/s; K3 "
          f"{2 * n4 * m4 * d4 / ms / 1e9:.1f} TFLOP/s, its plain version "
          f"{pms:.3f} ms)")
    return rows


# ------------------------------------------------- phase 11: LM training
TRAIN_ARGS = ("--arch", "gemma-2b", "--full-config", "--global-batch", "2",
              "--seq-len", "2048", "--steps", "12", "--microbatches", "1")
TRAIN_SEED = 30                    # (b)-(d)'s parameters and batches
TRAIN_SHORT = (2, 2048)            # (b): batch, tokens each
TRAIN_SMALL = (2, 64)              # (c): batch, tokens each
TRAIN_RESUME = (8, 4)              # (d): steps, the step it is killed at
STEP_LINE = r"step\s+(\d+)\s+loss (\S+)\s+gnorm (\S+)\s+(\d+) ms/step"


def train_lines(stdout: str, label: str) -> list:
    """(step, loss, grad norm, ms) of each step line a launcher printed."""
    import re
    rows = [(int(s), float(lo), float(gn), float(ms)) for s, lo, gn, ms in
            re.findall(STEP_LINE, stdout)]
    check(rows, f"{label}: no step lines in its output")
    return rows


def train_plain_loss(torch, logits, labels, z_loss: float = 1e-4) -> float:
    """The reference's masked CE with its z-loss, in f32 from (B, S, V)
    logits, as plain torch."""
    lg = logits.float()
    mask = (labels >= 0).float()
    lse = torch.logsumexp(lg, -1)
    ll = torch.gather(lg, -1, labels.clamp(min=0)[..., None])[..., 0]
    n = mask.sum().clamp(min=1.0)
    return float(((lse - ll) * mask).sum() / n
                 + z_loss * ((lse * mask) ** 2).sum() / n)


def train_clone(torch, T, OptState, params, opt):
    return (T.tree_map(torch.clone, params),
            OptState(T.tree_map(torch.clone, opt.mu),
                     T.tree_map(torch.clone, opt.nu), opt.step.clone()))


def train_breakdown(torch, cfg, dev, batch: dict, reps: int = 3) -> str:
    """Where a train step of `cfg` on `batch` spends its time on the card,
    in this process: the step's device time beside its wall time (the
    busy share) and its top kernels (`device_breakdown`), then, by CUDA
    events, the loss and gradients (`_value_and_grad`, the bf16 cast
    included) beside AdamW's update."""
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import AdamWConfig, adamw_init, \
        adamw_update
    from repro_torch.train.trainer import _value_and_grad, make_train_step
    model = Model(cfg)
    g = torch.Generator(device=dev)
    g.manual_seed(TRAIN_SEED)
    params = model.init_params(g, dev)
    opt = adamw_init(params)
    step = make_train_step(model, AdamWConfig())
    prof = device_breakdown(torch, lambda: step(params, opt, batch),
                            reps=reps, top=6)
    grads = [None]

    def fb():
        grads[0] = None
        grads[0] = _value_and_grad(model, params, batch, True)[1]

    fb_ms = time_ms(torch, fb, reps=reps)
    opt_ms = time_ms(torch, lambda: adamw_update(AdamWConfig(), grads[0],
                                                 opt, params), reps=reps)
    del params, opt, grads
    return (f"{prof}; loss and gradients {fb_ms:.1f} ms, AdamW "
            f"{opt_ms:.1f} ms")


def train_checks(dev, *, full_args=TRAIN_ARGS, configs=None,
                 short=TRAIN_SHORT, small=TRAIN_SMALL, resume=TRAIN_RESUME,
                 example_args=(), timeout=600.0) -> dict:
    """Phase 11: the LM substrate's training path (`repro_torch.train`,
    `launch.train`, `examples.train_lm`) on `dev` (the card; the CPU for
    a rehearsal with small `full_args`, `configs` and `example_args`):

      (a) `python -m repro_torch.launch.train` with `full_args` (gemma-2b
          at its published size, 2 x 2,048 tokens a step, 12 steps; remat
          "nothing", bf16 compute params) in a subprocess under the
          import blocker: exit 0, every loss and grad norm finite; the
          loss of each step, s a step after the first, tokens/s and the
          peak device memory;
      (b) gemma-2b at full width and `reduced_depth` in this process,
          `short` tokens: the first step's loss against a plain f32 CE
          (with the z-loss) over `forward_logits` on the same bf16 copy
          (1e-3 relative); microbatches=2 gradients within 5 % relative
          L1 of the full batch's; one step run twice from one state
          bitwise equal in parameters and moments; vocab_chunks=8 within
          5e-3 of the dense loss, each loss's peak memory printed;
      (c) the nine other architectures at `reduced()`, `small` tokens:
          one train step each with finite loss and gradients, bf16 and
          f32 compute params within 0.05, the MoE families under both
          dispatches within 1e-3;
      (d) kill and resume at `examples/train_lm`'s ~79 M config: `resume`
          = (8, 4): eight uninterrupted steps here, against four steps
          with a checkpoint in a subprocess and a fresh subprocess that
          resumes and runs four more: the losses and every leaf of the
          final checkpoint bitwise equal; the checkpoint's bytes, its
          save and restore seconds;
      (e) `python -m repro_torch.examples.train_lm` (+ `example_args`)
          under the blocker: exit 0, a loss drop > 0.3, ms a step.
    """
    import dataclasses
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import ARCH_IDS, get_config, reduced, \
        reduced_depth
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.examples import train_lm
    from repro_torch.launch.train import build_parser, run_training
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.model import Model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import AdamWConfig, OptState, \
        adamw_init
    from repro_torch.train.trainer import _compute_params, \
        _value_and_grad, make_train_step
    if configs is None:
        configs = {a: reduced(get_config(a)) for a in ARCH_IDS}
        configs["gemma-2b"] = reduced_depth(get_config("gemma-2b"))
    checks, times = [], {}
    finite = lambda tree: all(bool(torch.isfinite(t).all())
                              for t in T.leaves(tree))

    # (a) gemma-2b at its published size through the entry point
    t0 = time.perf_counter()
    args = ("repro_torch.launch.train", *full_args, "--log-every", "1",
            "--device", dev.type)
    out = run_blocked(*args, timeout=timeout)
    check(out.returncode == 0, f"(a) exit {out.returncode}: "
          f"{out.stderr[-3000:]}")
    rows = train_lines(out.stdout, "(a)")
    rep = runner_report(out.stdout)
    check(rep["leaked"] == [], f"(a) loaded {rep['leaked']}")
    check(all(math.isfinite(lo) and math.isfinite(gn)
              for _, lo, gn, _ in rows), "(a) a loss or grad norm is not "
          "finite")
    flag = build_parser().parse_args(list(full_args))
    check([r[0] for r in rows] == list(range(flag.steps)),
          f"(a) step lines {[r[0] for r in rows]}, expected {flag.steps}")
    tokens = flag.global_batch * flag.seq_len
    s_step = sum(r[3] for r in rows[1:]) / 1e3 / max(len(rows) - 1, 1)
    peak = rep["peak_bytes"]
    times["a"] = time.perf_counter() - t0
    print(f"  (a) {' '.join(full_args)}: losses "
          + " ".join(f"{r[1]:.4f}" for r in rows)
          + f"; grad norms {rows[0][2]:.3f} .. {rows[-1][2]:.3f}; first "
          f"step {rows[0][3] / 1e3:.2f} s, then {s_step:.3f} s a step, "
          f"{tokens / s_step:,.0f} tokens/s; peak "
          + ("not measured (CPU)" if peak is None
             else f"{peak / 1e9:.2f} GB")
          + f"; {times['a']:.1f} s with the process start")
    if dev.type == "cuda":
        fcfg = get_config(flag.arch)
        if not flag.full_config:
            fcfg = configs["gemma-2b"]
        fb = TokenPipeline(PipelineConfig(
            vocab=fcfg.vocab, seq_len=flag.seq_len,
            global_batch=flag.global_batch), device=dev).batch_at(0)
        torch.cuda.empty_cache()
        print(f"  (a) the same step in this process: "
              f"{train_breakdown(torch, fcfg, dev, fb)}")
        del fb
        torch.cuda.empty_cache()
    checks.append("a")

    # (b) gemma-2b at full width, reduced depth: the step's numbers
    t0 = time.perf_counter()
    cfg = configs["gemma-2b"]
    model = Model(cfg)
    g = torch.Generator(device=dev)
    g.manual_seed(TRAIN_SEED)
    held = lm_memory_start(torch, dev)
    params = model.init_params(g, dev)
    opt = adamw_init(params)
    batch = TokenPipeline(PipelineConfig(
        vocab=cfg.vocab, seq_len=short[1], global_batch=short[0],
        seed=TRAIN_SEED), device=dev).batch_at(0)
    step = make_train_step(model, AdamWConfig())
    with torch.no_grad():
        comp = _compute_params(params, True)
        plain = train_plain_loss(torch, T.forward_logits(
            comp, batch["tokens"], cfg), batch["labels"])
        del comp
    runs = []
    for _ in range(2):
        p, o = train_clone(torch, T, OptState, params, opt)
        runs.append(step(p, o, batch))
        lm_sync(torch, dev)
    loss = float(runs[0][2]["loss"])
    check(abs(loss - plain) <= 1e-3 * abs(plain), f"(b) first loss "
          f"{loss} against the plain f32 CE {plain}")
    same = all(torch.equal(a, b) for x, y in zip(runs[0][:2], runs[1][:2])
               for a, b in zip(T.leaves(x), T.leaves(y)))
    check(same, "(b) one step twice from one state differs")
    check(torch.equal(runs[0][2]["loss"], runs[1][2]["loss"]),
          "(b) the repeated step's loss differs")
    del runs, p, o
    _, g_full = _value_and_grad(model, params, batch, True)
    half = short[0] // 2
    parts = [_value_and_grad(model, params, {k: v[i * half:(i + 1) * half]
                                             for k, v in batch.items()},
                             True)[1] for i in range(2)]
    gn = dn = 0.0
    for a, b, c in zip(T.leaves(g_full), T.leaves(parts[0]),
                       T.leaves(parts[1])):
        gn += float(a.abs().sum())
        dn += float(((b + c) / 2 - a).abs().sum())
    del g_full, parts
    check(dn < 0.05 * gn, f"(b) microbatch gradients {dn / gn:.4f} "
          "relative L1 from the full batch's")
    peaks = {}
    losses_bc = {}
    for chunks in (0, 8):
        lm_sync(torch, dev)
        base = lm_memory_start(torch, dev)
        l_, gr = _value_and_grad(
            Model(dataclasses.replace(cfg, vocab_chunks=chunks)), params,
            batch, True)
        lm_sync(torch, dev)
        losses_bc[chunks] = float(l_)
        peaks[chunks] = lm_peak(torch, dev, base)
        del gr
    check(abs(losses_bc[8] - losses_bc[0]) < 5e-3, f"(b) chunked loss "
          f"{losses_bc[8]} against dense {losses_bc[0]}")
    times["b"] = time.perf_counter() - t0
    print(f"  (b) {cfg.name} at d_model {cfg.d_model}, {cfg.n_layers} "
          f"layers, {short[0]} x {short[1]} tokens: first loss {loss:.6f} "
          f"against the plain f32 CE {plain:.6f} (rel "
          f"{abs(loss - plain) / abs(plain):.2e}); microbatch gradients "
          f"{dn / gn:.2e} relative L1 from the full batch's; one step "
          f"twice bitwise equal; vocab_chunks=8 loss "
          f"{losses_bc[8]:.6f} against dense {losses_bc[0]:.6f}, "
          f"loss+grad {peaks[8]} chunked, {peaks[0]} dense; "
          f"{lm_peak(torch, dev, held)}; {times['b']:.1f} s")
    del params, opt, batch
    checks.append("b")

    # (c) the nine other architectures at reduced(): one step each
    t0 = time.perf_counter()
    notes = []
    for arch, acfg in configs.items():
        if arch == "gemma-2b":
            continue
        model = Model(acfg)
        params = model.init_params(g, dev)
        batch = TokenPipeline(PipelineConfig(
            vocab=acfg.vocab, seq_len=small[1], global_batch=small[0],
            seed=TRAIN_SEED), device=dev).batch_at(0)
        if acfg.family == "encdec":
            batch["frames"] = torch.randn(
                (small[0], acfg.enc_seq, acfg.d_model), generator=g,
                device=dev)
        l32, g32 = _value_and_grad(model, params, batch, False)
        l16, g16 = _value_and_grad(model, params, batch, True)
        check(math.isfinite(float(l32)) and finite(g32) and finite(g16),
              f"(c) {arch}: loss or gradients not finite")
        check(abs(float(l32) - float(l16)) < 0.05, f"(c) {arch}: bf16 "
              f"compute params {float(l16)} against f32 {float(l32)}")
        del g32, g16
        note = f"{arch} {float(l16):.4f} (f32 {float(l32):.4f})"
        if acfg.family == "moe":
            assert L.MOE_DISPATCH == "scatter"
            try:
                L.MOE_DISPATCH = "einsum"
                le, _ = _value_and_grad(model, params, batch, True)
            finally:
                L.MOE_DISPATCH = "scatter"
            check(abs(float(le) - float(l16)) < 1e-3, f"(c) {arch}: "
                  f"einsum dispatch {float(le)} against scatter "
                  f"{float(l16)}")
            note += f", einsum {float(le):.4f}"
        opt = adamw_init(params)
        p, o, m = make_train_step(model, AdamWConfig())(params, opt, batch)
        check(math.isfinite(float(m["loss"]))
              and math.isfinite(float(m["grad_norm"])) and finite(p),
              f"(c) {arch}: the train step is not finite")
        notes.append(note)
        del params, opt, p, o, batch
    times["c"] = time.perf_counter() - t0
    print(f"  (c) one train step each at reduced(), {small[0]} x "
          f"{small[1]} tokens, losses: " + "; ".join(notes)
          + f"; {times['c']:.1f} s")
    checks.append("c")

    # (d) kill and resume at train_lm's config
    t0 = time.perf_counter()
    rcfg, _, gb, seq = train_lm.config(dev.type == "cpu")
    total, kill = resume
    tmp = tempfile.mkdtemp()
    try:
        d_full, d_kill = os.path.join(tmp, "full"), os.path.join(tmp, "kill")
        kw = dict(global_batch=gb, seq_len=seq, ckpt_every=10**6, lr=1e-3,
                  log_every=10**6, device=dev)
        _, l_full = run_training(rcfg, steps=total, ckpt_dir=d_full, **kw)
        code = ("import json\n"
                "from repro_torch.examples.train_lm import config\n"
                "from repro_torch.launch.train import run_training\n"
                f"cfg, _, gb, seq = config({dev.type == 'cpu'})\n"
                "_, losses = run_training(cfg, steps={steps}, "
                f"global_batch=gb, seq_len=seq, ckpt_dir={d_kill!r}, "
                f"ckpt_every=10**6, lr=1e-3, log_every=10**6, "
                f"device={dev.type!r})\n"
                "print('losses: ' + json.dumps(losses))\n")
        got = []
        for steps in (kill, total):
            o = run_blocked("-c", code.replace("{steps}", str(steps)),
                            timeout=timeout)
            check(o.returncode == 0, f"(d) the run to step {steps}: "
                  f"exit {o.returncode}: {o.stderr[-3000:]}")
            line = [x for x in o.stdout.splitlines()
                    if x.startswith("losses: ")]
            check(line, f"(d) the run to step {steps} printed no losses")
            got.append(json.loads(line[-1][len("losses: "):]))
            if steps == total:
                check(f"resumed from step {kill}" in o.stdout,
                      "(d) the second run did not resume")
        check(got[0] == l_full[:kill] and got[1] == l_full[kill:],
              f"(d) losses {got} against uninterrupted {l_full}")
        tpl = {"params": Model(rcfg).abstract_params(),
               "opt": adamw_init(Model(rcfg).abstract_params())}
        a, _, _ = ckpt.restore(d_full, tpl, device="cpu")
        b, _, _ = ckpt.restore(d_kill, tpl, device="cpu")
        check(all(torch.equal(x, y) for x, y in zip(T.leaves(a),
                                                    T.leaves(b))),
              "(d) a leaf of the resumed run's state differs")
        nbytes = os.path.getsize(os.path.join(
            d_full, f"step_{total:08d}", "arrays.npz"))
        t1 = time.perf_counter()
        state, _, _ = ckpt.restore(d_full, tpl, device=dev)
        lm_sync(torch, dev)
        restore_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        ckpt.save(os.path.join(tmp, "again"), total, state)
        save_s = time.perf_counter() - t1
        del a, b, state
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    times["d"] = time.perf_counter() - t0
    print(f"  (d) {rcfg.n_layers} layers at d_model {rcfg.d_model}, vocab "
          f"{rcfg.vocab}, {gb} x {seq} tokens: {total} steps against "
          f"{kill} + {total - kill} across two processes, losses and the "
          f"state bitwise equal (losses {', '.join(f'{x:.4f}' for x in l_full)}"
          f"); checkpoint {nbytes:,} bytes, save {save_s:.2f} s, restore "
          f"to the device {restore_s:.2f} s; {times['d']:.1f} s")
    checks.append("d")

    # (e) the example under the blocker
    t0 = time.perf_counter()
    out = run_blocked("repro_torch.examples.train_lm", *example_args,
                      timeout=timeout)
    check(out.returncode == 0, f"(e) exit {out.returncode}: "
          f"{out.stderr[-3000:]}")
    drop = float(parse(r"\(drop (\S+) over", out.stdout, "e").group(1))
    ms = float(parse(r", (\S+) ms/step with checkpoints", out.stdout,
                     "e").group(1))
    check(drop > 0.3, f"(e) the loss dropped by {drop}")
    check(runner_report(out.stdout)["leaked"] == [], "(e) leaked modules")
    times["e"] = time.perf_counter() - t0
    print(f"  (e) examples.train_lm: loss drop {drop:.3f}, {ms:.1f} ms a "
          f"step with its checkpoints; {times['e']:.1f} s")
    checks.append("e")
    return {"checks": checks, "times": times}


# ------------------------------------- phase 12: sharded LM training
SHARD_ARGS = {"arch": "gemma-2b", "full": True, "steps": 4, "batch": 2,
              "seq": 2048, "ckpt_steps": 2}
DRY_ARGS = ("--arch", "gemma-2b", "--both-meshes", "--engine")


def sharded_lm_worker(spec: dict) -> None:
    """Phase 12 (a) and (b) in a process of their own (a process group
    is process-wide): a single-rank process group (NCCL on the card, gloo
    for a CPU rehearsal) and a 1x1 ("data", "model") mesh over it.

      (a) `run_training(spec's architecture, steps, global_batch, seq_len,
          mesh=<1x1>)` and the same call with mesh=None from the same
          seed, in the order sharded, plain, plain, sharded: the loss
          streams, the grad norms and every final parameter leaf bitwise
          equal in all four, every leaf on its `param_specs` placements;
          from `run_training`'s `record`, s a step after the first (up to
          the loss read on the host), tokens/s and peak memory of each
          run, the host time of a step's call (before the card is waited
          for), `model_flops_train` of a step and its share of the dense
          bf16 peak (`launch.mesh.H100_SXM`);
      (b) the architecture at full width and `reduced_depth` trained
          `ckpt_steps` steps on the mesh with a checkpoint, restored
          through `shardings=` onto the 1x1 mesh and through `device=`
          without one: one more step from each gives the same loss.

    Prints `phase12: {json}` last; any failed check raises."""
    import dataclasses
    import shutil
    import socket
    import tempfile
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config, reduced, reduced_depth
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.launch import train as LT
    from repro_torch.launch.mesh import H100_SXM
    from repro_torch.launch.roofline import model_flops_train
    from repro_torch.models.model import Model
    from repro_torch.models.sharding import distribute, placements_for, \
        rules_for
    from repro_torch.models.transformer import leaves, tree_map
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import AdamWConfig, OptState, \
        adamw_init
    from repro_torch.train.trainer import make_train_step

    dev = torch.device(spec["device"])
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize()) if cuda else (lambda: None)
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    kw = dict(init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    if cuda:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", device_id=torch.device("cuda", 0),
                                **kw)
    else:
        dist.init_process_group("gloo", **kw)
    backend = dist.get_backend()
    check(backend == ("nccl" if cuda else "gloo"), f"backend {backend}")
    mesh = init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data",
                                                               "model"))
    base = get_config(spec["arch"])
    cfg = base if spec["full"] else reduced(base)
    steps, gb, seq = spec["steps"], spec["batch"], spec["seq"]
    rec = {"backend": backend}

    # (a) sharded, plain, plain, sharded through the launcher: each
    # variant timed once first and once last, nothing else on the host
    order = ("sharded", "plain", "plain", "sharded")
    runs = {name: [] for name in order}
    first = None
    for name in order:
        m = mesh if name == "sharded" else None
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        got = {}
        params, losses = LT.run_training(
            cfg, steps=steps, global_batch=gb, seq_len=seq, mesh=m,
            ckpt_every=10**6, log_every=10**6, device=dev, record=got)
        peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
        if m is not None and "placements" not in rec:
            specs = Model(cfg).param_specs(rules_for(cfg, mesh,
                                                     batch_size=gb))
            placed = tree_map(lambda p, sp: tuple(p.placements)
                              == placements_for(mesh, sp), params, specs)
            check(all(leaves(placed)), "(a) a parameter leaf is not on its "
                  "param_specs placements")
            rec["placements"] = sorted({str(tuple(p.placements))
                                        for p in leaves(params)})
        local = lambda p: (p.to_local() if m is not None else p)
        final = [local(p).detach().cpu() for p in leaves(params)]
        if first is None:
            first = (losses, got["grad_norm"], final)
        else:
            check(losses == first[0], f"(a) {name} losses {losses} against "
                  f"{first[0]}")
            check(got["grad_norm"] == first[1], f"(a) {name} grad norms "
                  f"{got['grad_norm']} against {first[1]}")
            check(all(torch.equal(a, b) for a, b in zip(final, first[2])),
                  f"(a) a final parameter leaf of a {name} run differs from "
                  "the first run's")
        del params, final
        after = lambda xs: sum(xs[1:]) / max(len(xs) - 1, 1)
        runs[name].append(dict(s_step=after(got["step_s"]),
                               first_s=got["step_s"][0],
                               host_s=after(got["call_s"]), peak_gb=peak))
    del first
    a_losses, a_gnorm = losses, got["grad_norm"]
    tokens = gb * seq
    mf = model_flops_train(cfg, Model(cfg).abstract_params(), tokens)
    peak_flops = H100_SXM["peak_bf16_flops"]
    for rs in runs.values():
        for r in rs:
            r["tokens_s"] = tokens / r["s_step"]
            r["mfu"] = mf / r["s_step"] / peak_flops
    rec.update(a=runs, order=order, model_flops=mf)
    peak = lambda r: ("not measured (CPU)" if r["peak_gb"] is None
                      else f"{r['peak_gb']:.2f} GB")
    print(f"  (a) {cfg.name}, {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{steps} steps of {gb} x {seq} tokens through run_training, "
          f"{', '.join(order)} (a 1x1 {backend} mesh or none): losses "
          + " ".join(f"{x:.6f}" for x in a_losses)
          + f" and grad norms {' '.join(f'{x:.6f}' for x in a_gnorm)} "
          f"bitwise equal in all four, every final leaf bitwise equal, "
          f"placements {rec['placements']}")
    for i, name in enumerate(order):
        r = runs[name][order[:i].count(name)]
        print(f"  (a) run {i + 1}, {name}: first step {r['first_s']:.2f} s, "
              f"then {r['s_step']:.3f} s a step, {r['tokens_s']:,.0f} "
              f"tokens/s, peak {peak(r)}, host time of a step's call "
              f"{r['host_s'] * 1e3:.1f} ms; model_flops_train {mf:.4e} a "
              f"step = {r['mfu'] * 100:.1f}% of the dense bf16 peak "
              f"({peak_flops / 1e12:.0f} TFLOP/s)")
    extra = lambda k: (sum(r[k] for r in runs["sharded"])
                       - sum(r[k] for r in runs["plain"])) / 2
    print(f"  (a) the mesh adds {extra('host_s') * 1e3:.1f} ms of host time "
          f"a step and {extra('s_step') * 1e3:.1f} ms of wall time (means "
          f"of two runs each)")

    # (b) a checkpoint from the sharded run, restored two ways
    cfgb = reduced_depth(base) if spec["full"] else cfg
    model = Model(cfgb)
    k = spec["ckpt_steps"]
    tmp = tempfile.mkdtemp(dir=spec.get("tmp"))
    try:
        t0 = time.perf_counter()
        LT.run_training(cfgb, steps=k, global_batch=gb, seq_len=seq,
                        mesh=mesh, ckpt_dir=tmp, ckpt_every=10**6,
                        log_every=10**6, device=dev)
        sync()
        run_s = time.perf_counter() - t0
        rules = rules_for(cfgb, mesh, batch_size=gb)
        abstract = model.abstract_params()
        pshard = tree_map(lambda _, sp: (mesh, placements_for(mesh, sp)),
                          abstract, model.param_specs(rules))
        tpl = {"params": abstract, "opt": adamw_init(abstract)}
        batch = TokenPipeline(PipelineConfig(
            vocab=cfgb.vocab, seq_len=seq, global_batch=gb),
            device=dev).batch_at(k)
        got = {}
        for name in ("sharded", "plain"):
            t0 = time.perf_counter()
            if name == "sharded":
                state, at, _ = ckpt.restore(tmp, tpl, shardings={
                    "params": pshard, "opt": OptState(
                        mu=pshard, nu=pshard,
                        step=(mesh, placements_for(mesh, ())))})
                bspec = rules.spec("batch", None)
                bt = {n: distribute(v, mesh, bspec) for n, v in batch.items()}
                step = make_train_step(model, AdamWConfig(), rules)
            else:
                state, at, _ = ckpt.restore(tmp, tpl, device=dev)
                bt = batch
                step = make_train_step(model, AdamWConfig())
            sync()
            restore_s = time.perf_counter() - t0
            check(at == k, f"(b) restored step {at}, expected {k}")
            _, _, m = step(state["params"], state["opt"], bt)
            got[name] = (float(m["loss"]), restore_s)
            del state, m
            if cuda:
                torch.cuda.empty_cache()
        nbytes = os.path.getsize(os.path.join(tmp, f"step_{k:08d}",
                                              "arrays.npz"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(got["sharded"][0] == got["plain"][0], f"(b) the step after the "
          f"restore: loss {got['sharded'][0]} on the mesh, "
          f"{got['plain'][0]} without")
    rec["b"] = {"loss": got["plain"][0], "bytes": nbytes, "run_s": run_s,
                "restore_s": {n: v[1] for n, v in got.items()}}
    print(f"  (b) {cfgb.name} at {cfgb.n_layers} layers, d_model "
          f"{cfgb.d_model}: {k} sharded steps with a checkpoint of "
          f"{nbytes:,} bytes in {run_s:.1f} s; restored through shardings= "
          f"onto the 1x1 mesh in {got['sharded'][1]:.2f} s and through "
          f"device= in {got['plain'][1]:.2f} s; the next step's loss "
          f"{got['plain'][0]:.6f} on both")
    dist.destroy_process_group()
    print("phase12: " + json.dumps(rec), flush=True)


def sharded_lm_checks(dev, *, spec=None, dry_args=DRY_ARGS,
                      timeout=1200.0) -> dict:
    """Phase 12: the LM substrate's sharding, one part after the other, so
    that nothing else loads the host while (a) is timed:

      (a), (b) `sharded_lm_worker` in a subprocess under the import
          blocker (its doc);
      (c) `python -m repro_torch.launch.dryrun` with `dry_args` (gemma-2b
          on the 16x16 and 2x16x16 production meshes of a fake process
          group, and the row-sharded engine's cells at AMAZON_K on flat
          meshes of 256 and 512 shards; no card memory) and `--out` a
          temporary JSON, under the import blocker: exit 0; its records'
          table
          (`roofline_report --md`), and for each cell the three terms,
          the bottleneck and whether `bytes_per_device` fits 80 GB.
    """
    import shutil
    import tempfile
    spec = dict(SHARD_ARGS if spec is None else spec, device=dev.type)
    checks = []
    t0 = time.perf_counter()
    code = ("import json, sys\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "import chip_smoke\n"
            f"chip_smoke.sharded_lm_worker(json.loads({json.dumps(spec)!r}))\n")
    out = run_blocked("-c", code, timeout=timeout)
    for line in out.stdout.splitlines():
        if line.startswith("  ("):
            print(line)
    check(out.returncode == 0, f"(a)/(b) exit {out.returncode}: "
          f"{out.stderr[-4000:]}")
    rep = runner_report(out.stdout)
    check(rep["leaked"] == [], f"(a)/(b) loaded {rep['leaked']}")
    rec = json.loads([x for x in out.stdout.splitlines()
                      if x.startswith("phase12: ")][-1][len("phase12: "):])
    checks += ["a", "b"]
    print(f"  (a)/(b) {time.perf_counter() - t0:.1f} s with the process "
          f"start, peak {rep['peak_bytes']} bytes")

    tmp = tempfile.mkdtemp()
    out_json = os.path.join(tmp, "dryrun.json")
    t0 = time.perf_counter()
    dry = run_blocked("repro_torch.launch.dryrun", *dry_args, "--out",
                      out_json, timeout=timeout)
    rc = dry.returncode
    dry_s = time.perf_counter() - t0
    check(rc == 0, f"(c) the dry run's exit {rc}: " + dry.stderr[-4000:])
    rep = runner_report(dry.stdout)
    check(rep["leaked"] == [], f"(c) loaded {rep['leaked']}")
    check(rep["peak_bytes"] is None, "(c) the dry run used the card")
    from repro_torch.launch.roofline_report import rows_from, to_markdown
    with open(out_json) as f:
        records = json.load(f)
    check(records and all(r["status"] in ("OK", "SKIP") for r in records),
          "(c) a cell of the dry run failed")
    print("  (c) the dry run's table (roofline_report --md):")
    for line in to_markdown(rows_from(records)).splitlines():
        print("    " + line)
    for r in records:
        if r["status"] != "OK":
            continue
        roof = r["roofline"]
        print(f"  (c) [{r['mesh']}] {r['arch']} x {r['cell']}: compute "
              f"{roof['compute_s']:.4g} s, memory {roof['memory_s']:.4g} s, "
              f"collective {roof['collective_s']:.4g} s -> "
              f"{roof['bottleneck']}-bound; {r['bytes_per_device'] / 1e9:.2f}"
              f" GB a device ({r['arg_bytes'] / 1e9:.2f} arguments, "
              f"{r['temp_bytes'] / 1e9:.2f} temporaries): "
              + ("fits" if r["bytes_per_device"] <= 80e9 else "does not fit")
              + " 80 GB" + (f"; traced in {r['lower_s'] + r['compile_s']:.1f}"
                            " s" if "compile_s" in r else ""))
    print(f"  (c) {len(records)} records in {dry_s:.1f} s")
    shutil.rmtree(tmp, ignore_errors=True)
    checks.append("c")
    return {"checks": checks, "record": rec, "dryrun": records}


def digests_of(torch, exact_mod, rt_mod, ReverseKRanksEngine,
               RankTableConfig, synthetic_embeddings, ops, query_mod,
               pruning, PrunedBackend):
    """Phase 4's K2, K1 and K3 digests and f32 query profiles, phase
    4c (ii)'s K6 digests and phase 4b's 16 K4/K5/K7 digests, computed by
    the imported package on the same inputs (`--digests SRC`)."""
    import numpy as np
    dev = torch.device("cuda")
    print(f"package: {ops.__file__}")
    users, items, cfg, pos, w, qs = netflix_data(
        torch, rt_mod, synthetic_embeddings, RankTableConfig, dev)
    eng = ReverseKRanksEngine.build(users, items, cfg, None,
                                    backend="fused", device=dev,
                                    positions=pos, weights=w)
    print(f"  digest K2 (the f32 table, {N} x {TAU}): "
          f"{table_digest(eng.rank_table.table)}")
    for line in k1_digests(ops, users, qs, eng.rank_table):
        print(line)
    print("  f32 profile of fused query: " + device_breakdown(
        torch, lambda: eng.query(items[QUERY_ITEM], K, C)))
    print(f"  f32 profile of fused query_batch(B={B}): " + device_breakdown(
        torch, lambda: eng.query_batch(qs, K, C)))
    if importlib.util.find_spec("repro_torch.core.distributed") is not None:
        sh = ReverseKRanksEngine(users, eng.rank_table, cfg,
                                 backend="sharded",
                                 mesh=(dev,) * P_QUERY)
        print(f"  digest sharded (the f32 sharded query_batch, B={B}: "
              f"indices and candidate bounds): "
              f"{sharded_digest(torch, sh.query_batch(qs, K, C))}")
        del sh
    else:
        print("  digest sharded: n/a (this package has no sharded backend)")
    del eng
    eng_r = reordered_build(ReverseKRanksEngine, PrunedBackend, users, items,
                            cfg, pos, w, dev)
    eng_p = ReverseKRanksEngine(eng_r.users, eng_r.rank_table, cfg,
                                backend=PrunedBackend("fused",
                                                      max_union_frac=1.0))
    for line in k6_digests(torch, np, ops, pruning, eng_p, qs):
        print(line)
    del eng_r, eng_p
    truth, exact_idx, exact_rk = grade(torch, exact_mod, users, items, qs)
    print(f"  digest K3 ({B} rank vectors, {B} reverse_k_ranks (indices, "
          f"ranks)): {k3_digest(truth, exact_idx, exact_rk)}")
    del truth
    tables = {}
    for spec in ("bf16", "int8"):
        eng = ReverseKRanksEngine.build(
            users, items, RankTableConfig(tau=TAU, omega=OMEGA, s=S_PER,
                                          storage_dtype=spec),
            None, backend="fused", device=dev, positions=pos, weights=w)
        tables[spec] = (eng.stored_users, eng.rank_table)
    for line in quant_digests(torch, ops, query_mod, tables, users, qs):
        print(line)
    del tables
    if hasattr(ReverseKRanksEngine, "insert_items"):
        print(f"  digest delta (phase 4d's f32 fused delta bounds, B={B}): "
              + delta_digest(torch, dev, ReverseKRanksEngine,
                             RankTableConfig, synthetic_embeddings, ops,
                             query_mod, rt_mod))
    else:
        print("  digest delta: n/a (this package has no mutable index)")


def main() -> int:
    t_start = time.perf_counter()
    other = None
    if sys.argv[1:2] == ["--digests"]:
        if len(sys.argv) != 3:
            print("usage: chip_smoke.py [--digests SRC]", file=sys.stderr)
            return 2
        other = str(Path(sys.argv[2]).resolve())
        # measure the package under SRC: forget this tree's, which the
        # sizes above were read from
        for name in [m for m in sys.modules
                     if m.split(".")[0] == "repro_torch"]:
            del sys.modules[name]
        sys.path.insert(0, other)
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    try:
        from repro_torch.core import exact as exact_mod
        from repro_torch.core import metrics
        from repro_torch.core import pruning
        from repro_torch.core.backends import PrunedBackend
        from repro_torch.core import query as query_mod
        from repro_torch.core import rank_table as rt_mod
        from repro_torch.core.engine import ReverseKRanksEngine
        from repro_torch.core.types import RankTableConfig
        from repro_torch.data.pipeline import mid_mixture, \
            synthetic_embeddings
        from repro_torch.kernels import _build, ops, ref
    except ImportError as e:
        print(f"FAIL: the port is not importable here ({e}); run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    if other is not None:
        digests_of(torch, exact_mod, rt_mod, ReverseKRanksEngine,
                   RankTableConfig, synthetic_embeddings, ops, query_mod,
                   pruning, PrunedBackend)
        return 0
    try:
        kernels = run(torch, exact_mod, metrics, query_mod, rt_mod,
                      ReverseKRanksEngine, RankTableConfig,
                      synthetic_embeddings, _build, ops, ref, pruning,
                      PrunedBackend, mid_mixture)
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


# phase 5b's cells: the benchmark's two (name, n users, m items, storage)
SELECT_CELLS = (("netflix-f32", N, M, "float32"),
                ("amazon-k-int8", 1_406_890, 430_530, "int8"))


def selection_checks(dev, *, cells=SELECT_CELLS, d=D, nb=B, k=K, c=C,
                     reps=50) -> list:
    """Phase 5b, the selection kernels (`csrc/select_topk.cu`) on step 1's
    real outputs at each cell's shape: a fused engine over synthetic
    embeddings (seed 0, build seed 1) at (n, m, storage), nb item queries
    (seed 2), step 1's user-major (nb, n) views from
    `ops.bound_ranks_batched_stored`. The kernel (`ops.select_topk`) must
    be bitwise the plain version (`select_topk_plain`) in all nine fields,
    counting one `select_kth` and one `select_lemma1` launch a call; then
    both are timed by CUDA events, the kernel beside its bound, r_lo and
    r_up read by each stage and est by the second: 5·n·nb·4 bytes at
    3.35 TB/s. Returns a kernel record a cell."""
    import torch
    from repro_torch.core import query as query_mod
    from repro_torch.core.engine import ReverseKRanksEngine
    from repro_torch.core.types import RankTableConfig
    from repro_torch.data.pipeline import synthetic_embeddings
    from repro_torch.kernels import ops
    print(f"phase: the selection kernels on step 1's outputs, B={nb}, k={k}")
    recs = []
    for name, n, m, storage in cells:
        users, items = synthetic_embeddings(0, n, m, d, device=dev)
        cfg = RankTableConfig(tau=TAU, omega=OMEGA, s=S_PER,
                              storage_dtype=storage)
        eng = ReverseKRanksEngine.build(users, items, cfg, 1,
                                        backend="fused", device=dev)
        g = torch.Generator(device=dev)
        g.manual_seed(2)
        qs = items[torch.randperm(m, generator=g, device=dev)[:nb]] \
            .contiguous()
        del users, items
        snap = eng.current_snapshot()
        bounds = ops.bound_ranks_batched_stored(snap.query_users(), qs,
                                                snap.rank_table)
        check(bounds[0].stride() == (1, nb),
              f"{name}: step 1's bounds are not user-major views")
        ops.reset_launch_counts()
        got = ops.select_topk(*bounds, k=k, c=c, m_items=m)
        torch.cuda.synchronize()
        launches = {x: v for x, v in ops.LAUNCHES.items() if v}
        check(launches == {"select_kth": 1, "select_lemma1": 1},
              f"{name}: launches {launches}, expected one of each stage")
        want = query_mod.select_topk_plain(*bounds, k=k, c=c, m_items=m)
        differ = [f for f in got._fields
                  if getattr(got, f).dtype != getattr(want, f).dtype
                  or not torch.equal(getattr(got, f), getattr(want, f))]
        check(not differ, f"{name}: the selection kernels differ from the "
              f"plain version in {differ}")
        ms = time_ms(torch, lambda: ops.select_topk(*bounds, k=k, c=c,
                                                    m_items=m), reps=reps)
        pms = time_ms(torch, lambda: query_mod.select_topk_plain(
            *bounds, k=k, c=c, m_items=m), reps=10)
        print(f"  {name}: n={n}, bitwise the plain version in all nine "
              f"fields ({int(got.guaranteed.sum())} of {nb} guaranteed, "
              f"n_accepted {got.n_accepted.tolist()}); "
              + device_breakdown(torch, lambda: ops.select_topk(
                  *bounds, k=k, c=c, m_items=m), reps=reps))
        recs.append(kernel_record(
            f"select_topk[{name}, B={nb}, k={k}]", None, 2, 0.0, ms, pms,
            5 * n * nb * 4, 0, "src/repro_torch/kernels/csrc/select_topk.cu"))
        del eng, snap, bounds, got, want, qs
        torch.cuda.empty_cache()
    return recs


def kernel_record(name, replaces, launches, err, ms, plain_ms, bound_bytes,
                  bound_ops, source) -> dict:
    """One kernel's entry of the kernels line, printed: its bound is the
    larger of the bytes it must move over the HBM rate and its f32
    operations over the f32 peak."""
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
    return rec


def run(torch, exact_mod, metrics, query_mod, rt_mod, ReverseKRanksEngine,
        RankTableConfig, synthetic_embeddings, _build, ops, ref, pruning,
        PrunedBackend, mid_mixture):
    import numpy as np
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
    print(f"K4/K5/K7 launches at d={D} tau={TAU}:")
    for line in quant_configs(ops):
        print(line)
    print(f"K1/K6 launches at tau={TAU}:")
    for line in k1_configs(ops, (1, 37, D_WIDE, D_LONG)):
        print(line)
    print("K3 launches:")
    k3_ds = k3_edge_depths(ops)
    for d in (D,) + k3_ds:
        print(k3_config_line(ops, d))
    print("K2 launches:")
    k2_cap = k2_resident_cap(ops, S_MAIN)
    for n, d, S in ((N, D, S_MAIN), (300, k2_cap + 1, 500),
                    (300, D_WIDE, 4096)):
        print(k2_config_line(ops, n, d, S))

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

    # 3b. Qᵀ streamed through shared memory, the user tile of K3 and the
    # depth of K2 cut, at a d past every former shared-memory cap; its own
    # generator, so that the earlier phases' inputs (and lines) are as
    # they were
    print(f"phase: kernels vs plain at d = {D_WIDE}")
    g2 = torch.Generator(device=dev)
    g2.manual_seed(11)
    n, m, tau = 500, 400, 128
    users = torch.randn((n, D_WIDE), generator=g2, device=dev)
    items = torch.randn((m, D_WIDE), generator=g2, device=dev)
    cfg = RankTableConfig(tau=tau, omega=4, s=16)
    items_sorted, _ = rt_mod.sort_items_by_norm(items)
    pos, w = rt_mod.stratified_sample_indices(m, cfg, g2)
    rt = rt_mod.build_rank_table_sorted(users, items_sorted, cfg,
                                        positions=pos, weights=w)
    check_k2(torch, ops, ref, users, items_sorted[pos].contiguous(), w,
             rt.thresholds, f"d={D_WIDE}")
    for nb in (1, 16, 19):
        check_k1(torch, ops, ref, users, items[:nb].contiguous(),
                 rt.thresholds, rt.table, m, f"d={D_WIDE}")
    for q, what in ((items[11], "q in P"),
                    (torch.randn((D_WIDE,), generator=g2, device=dev),
                     "random q")):
        _, n_diff, err = check_k3(torch, ops, ref, users, items,
                                  q.contiguous(), f"d={D_WIDE}")
        print(f"  K3 d={D_WIDE} ({what}): n={n} m={m}: {n_diff} ranks "
              f"differ, all explained; max abs err {err}")
    iu = torch.randint(-4, 5, (n, D_WIDE), generator=g2, device=dev).float()
    ii = torch.randint(-4, 5, (m, D_WIDE), generator=g2, device=dev).float()
    for spec in ("bf16", "int8"):
        cfg = RankTableConfig(tau=37, omega=4, s=16, storage_dtype=spec)
        rt_i = rt_mod.build_rank_table(iu, ii, cfg, g2)
        rt_r = cfg.storage.pack_table(rt.thresholds, rt.table, m=m)
        for u, what in ((cfg.storage.pack_users(iu), "stored"),
                        (iu, "raw f32")):
            for nb in (1, 16, 19):
                check_quant_exact(torch, ops, ref, Q, u,
                                  ii[:nb].contiguous(), rt_i,
                                  f"{spec} d={D_WIDE} {what} B={nb}")
        su = cfg.storage.pack_users(users)
        qn = Q.query_l1(items[:19])
        first = [x[:, 0] for x in quant_launches(torch, ops, su, items[:1],
                                                 qn[:1], rt_r)]
        got = [x[:, 0] for x in quant_launches(torch, ops, su, items[:19],
                                               qn, rt_r)]
        check(all(torch.equal(a, b) for a, b in zip(got, first)),
              f"{spec} d={D_WIDE}: query 0 at B=19 differs from B=1")
        check_quant(torch, ops, ref, Q, su, items[:19].contiguous(), rt_r,
                    f"{spec} d={D_WIDE} stored randn")
        print(f"  {spec} d={D_WIDE}: integer inputs exact (stored and raw "
              "f32, B in 1,16,19); randn query 0 bitwise at B=1 and 19")

    # 3c. K6 / K7: the kernels behind a row map, against K1/K4/K5 on the
    # same rows (bitwise) and against their plain versions
    print("phase: K6/K7 vs K1/K4/K5 and plain, ragged tiles")
    g3 = torch.Generator(device=dev)
    g3.manual_seed(13)
    n, m, bn = 1000, 777, 256
    id_lists = ((0, 2, 3), (3, 1, 1, 3), (1,))    # tail, duplicates, nk = 1
    for d, tau in ((37, 777), (D_WIDE, 128)):
        users = torch.randn((n, d), generator=g3, device=dev)
        items = torch.randn((m, d), generator=g3, device=dev)
        for spec in ("f32", "bf16", "int8"):
            cfg = RankTableConfig(tau=tau, omega=4, s=16, storage_dtype=spec)
            rt = rt_mod.build_rank_table(users, items, cfg, g3)
            su = cfg.storage.pack_users(users)
            row_sets = ((users, "raw f32"),) if su is None else (
                (su, "stored"), (users, "raw f32"))
            for u, what in row_sets:
                for nb in (1, 3, 16, 19):
                    qs = items[:nb].contiguous()
                    full = ops.bound_ranks_batched_stored(u, qs, rt)
                    for li, ids in enumerate(id_lists):
                        ids_t = torch.tensor(ids, dtype=torch.int32,
                                             device=dev)
                        got = ops.bound_ranks_batched_pruned_stored(
                            u, qs, rt, ids_t, block_n=bn)
                        ridx = pruning.row_indices(ids_t, bn).long()
                        live = ridx < n
                        for a, b in zip(got, full):
                            check(torch.equal(a[:, live],
                                              b[:, ridx[live]]),
                                  f"{spec} d={d} {what} B={nb} ids={ids}: "
                                  "masked kernel differs from the full "
                                  "scan on its kept rows")
                            check(bool((a[:, ~live] == float(m + 2)).all()),
                                  f"{spec} d={d}: rows past n are not m+2")
                        if li or nb not in (1, 19):
                            continue
                        kr = ridx[live]
                        kept = [x[:, live].T for x in got]
                        if spec == "f32":
                            check_k1(torch, ops, ref, users[kr], qs,
                                     rt.thresholds[kr], rt.table[kr], m,
                                     f"vs plain d={d} ids={ids}", got=kept,
                                     name="K6")
                        else:
                            check_quant(torch, ops, ref, Q,
                                        users[kr] if u is users
                                        else su.take_rows(kr),
                                        qs, rt.take_rows(kr),
                                        f"K7 {spec} {what} vs plain d={d} "
                                        f"ids={ids}", got=kept)
            print(f"  {'K6' if spec == 'f32' else 'K7 ' + spec}: d={d} "
                  f"tau={tau}, B in 1,3,16,19, ids {id_lists}: kept rows "
                  "bitwise the full scan's, rows past n at m+2")

    # 3d. K3 at its edges: ragged n and m; an odd depth, the last depth of
    # its resident user tile and the next, d = 1,031; views U[1:] and
    # P[1:], and rows 4 bytes past a 16-byte boundary; q in P. Its own
    # generator, as 3b's.
    print("phase: K3 at its edges")
    g4 = torch.Generator(device=dev)
    g4.manual_seed(17)
    for d in k3_ds:
        cfg = ops.exact_rank.launch_config(d)
        users = torch.randn((1000, d), generator=g4, device=dev)
        items = torch.randn((777, d), generator=g4, device=dev)
        iu = torch.randint(-4, 5, (1000, d), generator=g4, device=dev).float()
        ii = torch.randint(-4, 5, (777, d), generator=g4, device=dev).float()
        cases = lambda u, p: ((u, p, "whole"),
                              (u[1:], p[1:], "views U[1:], P[1:]"),
                              (offset_view(torch, u), offset_view(torch, p),
                               "rows off 16 bytes"))
        n_diff = 0
        for u, p, what in cases(users, items):
            for q in (p[11], torch.randn((d,), generator=g4, device=dev)):
                n_diff += check_k3(torch, ops, ref, u, p, q.contiguous(),
                                   f"d={d} {what}")[1]
        for u, p, what in cases(iu, ii):
            for q in (p[11], p[0] + 1.0):
                check(torch.equal(ops.exact_ranks(u, p, q.contiguous()),
                                  1 + ref.ref_exact_counts(u, p, q)),
                      f"K3 d={d} {what}: integer inputs differ from the "
                      "plain version")
        print(f"  K3 d={d} (user tile "
              f"{'resident' if cfg['users_resident'] else 'staged'}"
              "): n=1000 m=777, whole, U[1:]/P[1:] views and rows "
              f"off 16 bytes, q in P and random q: {n_diff} ranks differ "
              "from plain, all explained; integer inputs bitwise the plain "
              "version's")

    # 3e. K4/K5/K7 on views at an offset and on long rows
    print("phase: K4/K5/K7 on views at an offset and on long rows")
    g5 = torch.Generator(device=dev)
    g5.manual_seed(19)
    iu = torch.randint(-4, 5, (300, 37), generator=g5, device=dev).float()
    ii = torch.randint(-4, 5, (300, 37), generator=g5, device=dev).float()
    ids = torch.tensor([1, 0, 1], dtype=torch.int32, device=dev)
    for spec in ("bf16", "int8"):
        cfg = RankTableConfig(tau=37, omega=4, s=16, storage_dtype=spec)
        rt = rt_mod.build_rank_table(iu, ii, cfg, g5)
        (rt_v, rt_c), (su_v, su_c) = row_views(rt,
                                               cfg.storage.pack_users(iu))
        for u_v, u_c, what in ((su_v, su_c, "stored"),
                               (iu[1:], iu[1:].clone(), "raw f32")):
            for nb in (1, 3, 16, 19):
                qs = ii[:nb].contiguous()
                pruned = lambda u, q, r: \
                    ops.bound_ranks_batched_pruned_stored(u, q, r, ids,
                                                          block_n=64)
                for fn in (ops.bound_ranks_batched_stored, pruned):
                    got, want = fn(u_v, qs, rt_v), fn(u_c, qs, rt_c)
                    check(all(torch.equal(a, b) for a, b in zip(got, want)),
                          f"{spec} {what} B={nb}: a view at an offset differs "
                          "from the same call on a copy")
                check_quant_exact(torch, ops, ref, Q, u_v, qs, rt_v,
                                  f"{spec} view {what} B={nb}")
        print(f"  {spec} (K{4 if spec == 'bf16' else 5}, K7): n=299 d=37 "
              "views from row 1 of every staged array, stored and raw f32 "
              "rows, B in 1,3,16,19: bitwise the same call on copies; "
              "bounds exact against plain")
    iu = torch.randint(-4, 5, (70, D_LONG), generator=g5, device=dev).float()
    ii = torch.randint(-4, 5, (300, D_LONG), generator=g5, device=dev).float()
    for spec in ("bf16", "int8"):
        cfg = RankTableConfig(tau=33, omega=4, s=16, storage_dtype=spec)
        rt = rt_mod.build_rank_table(iu, ii, cfg, g5)
        chunks = []
        for u, raw, what in ((cfg.storage.pack_users(iu), False, "stored"),
                             (iu, True, "raw f32")):
            chunks.append(ops.user_scores.quant_launch_config(
                spec, raw, B, D_LONG, 33)["row_chunk"])
            for nb in (1, 16):
                qs = ii[:nb].contiguous()
                full = check_quant_exact(torch, ops, ref, Q, u, qs, rt,
                                         f"{spec} d={D_LONG} {what} B={nb}")
                got = ops.bound_ranks_batched_pruned_stored(u, qs, rt, ids,
                                                            block_n=64)
                ridx = pruning.row_indices(ids, 64).long()
                live = ridx < 70
                check(all(torch.equal(a[:, live], b.T[:, ridx[live]])
                          for a, b in zip(got, full)),
                      f"{spec} d={D_LONG} {what}: K7 differs from the full "
                      "scan on its kept rows")
        check(chunks[1] < D_LONG, f"{spec}: raw f32 rows at d={D_LONG} "
              "are not streamed in chunks")
        print(f"  {spec}: n=70 d={D_LONG} tau=33, B in 1,16, values of a row "
              f"a stage: stored {chunks[0]}, raw f32 {chunks[1]}: bounds "
              "exact against plain, est within 1e-5, K7 bitwise the full "
              "scan on its kept rows")

    # 3f. K2 at its edges: part of a sample tile (S = 40, 777), the main
    # path's S, four runs of its count (4,096); tau from 1 to past 1,024;
    # the product's resident user tile at its last depth and the next;
    # rows of thresholds in any order; views from row 1; scores on a
    # threshold and zero scores against +-0.0. Its own generator.
    print("phase: K2 at its edges")
    g6 = torch.Generator(device=dev)
    g6.manual_seed(23)
    n_cases = 0
    for S in (40, S_MAIN, 777, 4096):
        for d, tau in ((37, 1), (37, 37), (37, 500), (37, 1031), (k2_cap, 37),
                       (k2_cap + 1, 500), (D_WIDE, 37)):
            iu = torch.randint(-4, 5, (300, d), generator=g6,
                               device=dev).float()
            ip = torch.randint(-4, 5, (S, d), generator=g6, device=dev).float()
            iu[0] = 0.0
            top = int((iu @ ip.T).abs().max()) + 2
            thr = (torch.randint(-top, top, (300, tau), generator=g6,
                                 device=dev)
                   + 0.5 * torch.randint(0, 2, (300, tau), generator=g6,
                                         device=dev)).float()
            thr[0, :2] = torch.tensor([-0.0, 0.0], device=dev)[:tau]
            wi = torch.randint(1, 4, (S,), generator=g6, device=dev).float()
            asc = torch.sort(thr, dim=1).values
            perm = torch.argsort(torch.rand((300, tau), generator=g6,
                                            device=dev), dim=1)
            # integer weights (each sorts with its key), equal dyadic ones
            # (keys sort alone), one integer a run of 64 (parts of both)
            for wts, kind in (
                    (wi, "integer"),
                    (torch.full((S,), 1777 / 64, device=dev), "equal"),
                    (torch.repeat_interleave(wi[:S // 64 + 1], 64)[:S],
                     "runs of 64")):
                for t, what in ((asc.contiguous(), "ascending"),
                                (torch.flip(asc, [1]).contiguous(),
                                 "descending"),
                                (torch.gather(asc, 1, perm), "shuffled")):
                    got = ops.build_table_rows(iu, ip, wts, t)
                    check(torch.equal(got,
                                      ref.ref_table_rows(iu, ip, wts, t)),
                          f"K2 S={S} d={d} tau={tau} {what}, {kind} "
                          "weights: integer inputs differ from the plain "
                          "version")
                    check(torch.equal(got,
                                      ops.build_table_rows(iu, ip, wts, t)),
                          f"K2 S={S} d={d} tau={tau} {what}, {kind} "
                          "weights: two launches differ")
                    n_cases += 1
            check(torch.equal(
                ops.build_table_rows(iu[1:], ip[1:], wi[1:], thr[1:]),
                ref.ref_table_rows(iu[1:], ip[1:], wi[1:], thr[1:])),
                f"K2 S={S} d={d} tau={tau}: views from row 1 differ from "
                "the plain version")
            n_cases += 1
        users = torch.randn((1000, 37), generator=g6, device=dev)
        samples = torch.randn((S, 37), generator=g6, device=dev)
        sc = users @ samples.T
        grid = rt_mod.threshold_grid(sc.min(dim=1).values,
                                     sc.max(dim=1).values, 64)
        perm = torch.argsort(torch.rand((1000, 64), generator=g6,
                                        device=dev), dim=1)
        w_rand = torch.rand((S,), generator=g6, device=dev) + 0.5
        check_k2(torch, ops, ref, users, samples, w_rand,
                 torch.gather(grid, 1, perm), "random weights, shuffled rows")
    print(f"  K2: S in 40, {S_MAIN}, 777, 4096; d in 37, {k2_cap}, "
          f"{k2_cap + 1}, {D_WIDE}; tau in 1, 37, 500, 1031: {n_cases} "
          "integer cases (integer, equal and runs-of-64 weights; rows "
          "ascending, descending and shuffled; views from row 1; ties, "
          "+-0.0) bitwise the plain version, two launches equal")

    # 3g. K1/K6 at the edges of their ring (k1_edges, which the cuda tests
    # of tests/test_torch_kernels.py and test_torch_pruning.py run too)
    print("phase: K1/K6 at their edges, integer inputs")
    for case in K1_EDGE_CASES:
        print("  " + k1_edges(torch, ops, ref, ops.user_scores, pruning,
                              case) + ": bitwise the plain version")

    print("phase: K1/K4/K5 elastic entries, the row count read on the "
          "device, integer inputs")
    for line in elastic_entry_checks(dev):
        print(line)

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
    users, items, cfg, pos, w, qs = netflix_data(
        torch, rt_mod, synthetic_embeddings, RankTableConfig, dev)
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
    t0 = time.perf_counter()
    truth, exact_idx, exact_rk = grade(torch, exact_mod, users, items, qs)
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    print(f"  launches on the main path: {counts}")
    for name in ("k1_bound_ranks", "k2_table_build", "k3_exact_ranks",
                 "select_kth", "select_lemma1"):
        check(counts[name] >= 1,
              f"kernel {name} was not launched on the main path")
    mem = eng.memory_bytes()
    print(f"  digest K2 (the f32 table, {N} x {TAU}): "
          f"{table_digest(eng.rank_table.table)}")
    for line in k1_digests(ops, users, qs, eng.rank_table):
        print(line)
    print(f"  build {build_s:.3f} s (host clock, incl. sort, sampling and "
          f"the K2 launch); query_batch(B={B}) {qb_ms:.2f} ms; query "
          f"{q1_ms:.2f} ms; exact grading {exact_s:.2f} s for {B} queries "
          f"({2 * B} K3 launches: ranks + reverse_k_ranks)")
    print(f"  memory_bytes {mem} ({mem / 1e9:.3f} GB); peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    print(f"  digest K3 ({B} rank vectors, {B} reverse_k_ranks (indices, "
          f"ranks)): {k3_digest(truth, exact_idx, exact_rk)}")

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
    grades4 = (list(accs), list(ratios))      # phase 7 (d) audits these
    # steady state, CUDA events around 10 calls each: the whole query and
    # its selection (steps 2-3) alone on the same bounds
    qb_steady = time_ms(torch, lambda: eng.query_batch(qs, K, C), reps=10)
    q1_steady = time_ms(torch, lambda: eng.query(items[QUERY_ITEM], K, C),
                        reps=10)
    sel_steady = time_ms(torch, lambda: query_mod.select_topk(
        *f_bounds, k=K, c=C, m_items=M), reps=10)
    print(f"  steady state: query_batch(B={B}) {qb_steady:.3f} ms, of which "
          f"selection {sel_steady:.3f} ms; query {q1_steady:.3f} ms")
    print("  f32 profile of fused query: " + device_breakdown(
        torch, lambda: eng.query(items[QUERY_ITEM], K, C)))
    print(f"  f32 profile of fused query_batch(B={B}): " + device_breakdown(
        torch, lambda: eng.query_batch(qs, K, C)))

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
        # the 16. ‖q‖₁ is summed in an order fixed by d alone, so it is
        # the same for one query as for 16, and the fused query(q) must
        # be row 0 of query_batch (the dense path's product is not
        # bitwise across B)
        qn = query_mod.query_l1(qs)
        one = quant_launches(torch, ops, eng_s.stored_users, qs[:1], qn[:1],
                             eng_s.rank_table)
        all16 = quant_launches(torch, ops, eng_s.stored_users, qs, qn,
                               eng_s.rank_table)
        check(all(torch.equal(a[:, 0], b[:, 0]) for a, b in zip(one, all16)),
              f"{spec}: K{kid} query 0 at B=1 differs from B=16 with the "
              "same ‖q‖₁")
        del one, all16
        check(bool(qn[0] == query_mod.query_l1(qs[:1])[0]),
              f"{spec}: ‖q‖₁ of query 0 differs between B=1 and B=16")
        r1 = t["res1"]
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
              f"0 of query_batch and ‖q‖₁ the same at B=1 and B=16: checked "
              f"(K{kid} query 0 at B=1 = B=16 with one ‖q‖₁: checked); "
              f"dense query(q) selects row 0's users: {dense_row0}")
        qb_st = time_ms(torch, lambda: eng_s.query_batch(qs, K, C), reps=10)
        q1_st = time_ms(torch, lambda: eng_s.query(items[QUERY_ITEM], K, C),
                        reps=10)
        qb_dn = time_ms(torch, lambda: t["dense"].query_batch(qs, K, C),
                        reps=5)
        print(f"  {spec} steady state: fused query_batch(B={B}) "
              f"{qb_st:.3f} ms, query {q1_st:.3f} ms; dense query_batch "
              f"{qb_dn:.3f} ms")
        print(f"  {spec} profile of fused query_batch(B={B}): "
              + device_breakdown(torch, lambda: eng_s.query_batch(qs, K, C)))

    # the outputs' digests, for comparison with another tree's
    print("phase: K4/K5/K7 output digests, Netflix size")
    for line in quant_digests(torch, ops, query_mod, {
            spec: (t["eng"].stored_users, t["eng"].rank_table)
            for spec, t in tier.items()}, users, qs):
        print(line)

    # 4c. block-pruned queries on the main path's data, reordered
    print(f"phase: block-pruned queries, n={N} m={M} d={D} tau={TAU}, "
          f"B={B}, cluster_reorder=True")
    t0 = time.perf_counter()
    eng_r = reordered_build(ReverseKRanksEngine, PrunedBackend, users, items,
                            cfg, pos, w, dev)
    torch.cuda.synchronize()
    build_r = time.perf_counter() - t0
    check(eng_r.user_remap is not None, "the k-means layout is the identity")
    check(torch.equal(eng_r.users, users[torch.argsort(eng_r.user_remap)]),
          "the reordered users are not the users in remap order")
    fused_r = ReverseKRanksEngine(eng_r.users, eng_r.rank_table, cfg,
                                  backend="fused")
    res_p = eng_r.query_batch(qs, K, C)
    st = eng_r._backend.stats
    same_selection(torch, res_p, fused_r.query_batch(qs, K, C),
                   "(i) pruned:fused, default cap")
    print(f"  (i) build with cluster_reorder {build_r:.3f} s (host clock, "
          f"k-means + K2); pruned:fused at max_union_frac=0.5: kept union "
          f"{st.kept_union} of {st.n_blocks} blocks, skip rate "
          f"{st.skip_rate:.4f}, kept per query {st.kept_per_query:.4f}, "
          f"fallback {st.fallback or 'none'}; indices, est, R_k bitwise "
          "the full-scan fused engine's")
    qb_pr = time_ms(torch, lambda: eng_r.query_batch(qs, K, C), reps=10)
    qb_fr = time_ms(torch, lambda: fused_r.query_batch(qs, K, C), reps=10)
    print(f"  (i) steady state query_batch(B={B}): pruned:fused {qb_pr:.3f} "
          f"ms, fused {qb_fr:.3f} ms")

    # (ii) the pruned path forced (max_union_frac = 1.0) at every spec:
    # the launch counts of K6/K7 come from this run
    ops.reset_launch_counts()
    forced = {}
    for spec in ("f32", "bf16", "int8"):
        cfg_s = cfg if spec == "f32" else RankTableConfig(
            tau=TAU, omega=OMEGA, s=S_PER, storage_dtype=spec)
        base = eng_r if spec == "f32" else ReverseKRanksEngine.build(
            users, items, cfg_s, None, backend="fused", device=dev,
            positions=pos, weights=w, cluster_reorder=True)
        check(torch.equal(base.user_remap, eng_r.user_remap),
              f"{spec}: the k-means layout differs from the f32 build's")
        eng_p = ReverseKRanksEngine(
            base.users, base.rank_table, cfg_s,
            backend=PrunedBackend("fused", max_union_frac=1.0))
        res = eng_p.query_batch(qs, K, C)
        stats = eng_p._backend.stats
        res1 = eng_p.query(items[QUERY_ITEM], K, C)
        eng_f = ReverseKRanksEngine(base.users, base.rank_table, cfg_s,
                                    backend="fused")
        forced[spec] = dict(eng_p=eng_p, eng_f=eng_f, res=res, res1=res1,
                            stats=stats, res_f=eng_f.query_batch(qs, K, C))
    torch.cuda.synchronize()
    counts_p = dict(ops.LAUNCHES)
    print(f"  (ii) launches on the forced pruned path: {counts_p}")
    for line in k6_digests(torch, np, ops, pruning, forced["f32"]["eng_p"],
                           qs):
        print(line)
    for name in ("k6_bound_ranks_masked", "k7_bound_ranks_bf16_masked",
                 "k7_bound_ranks_int8_masked"):
        check(counts_p[name] >= 1,
              f"kernel {name} was not launched on the pruned path")
    for spec, f in forced.items():
        st = f["stats"]
        check(st.fallback == "", f"{spec}: the forced pruned path fell back")
        same_selection(torch, f["res"], f["res_f"],
                       f"(ii) {spec} pruned:fused")
        r1 = f["res1"]
        for fld in ("indices", "est_rank", "R_lo_k", "R_up_k", "guaranteed"):
            check(torch.equal(getattr(r1, fld), getattr(f["res"], fld)[0]),
                  f"(ii) {spec}: query(q) {fld} differs from row 0 of "
                  "query_batch")
        qb_p = time_ms(torch, lambda: f["eng_p"].query_batch(qs, K, C),
                       reps=10)
        qb_f = time_ms(torch, lambda: f["eng_f"].query_batch(qs, K, C),
                       reps=10)
        print(f"  (ii) {spec} pruned:fused at max_union_frac=1.0: kept "
              f"union {st.kept_union} of {st.n_blocks}, skip rate "
              f"{st.skip_rate:.4f}; indices, est, R_k bitwise the full "
              f"scan's; query(q) = row 0 of query_batch; steady "
              f"query_batch {qb_p:.3f} ms (fused {qb_f:.3f} ms)")

    # (iii) the mid-entropy regime, reordered, with a hot-cluster batch
    mu_, mi_, micl = mid_mixture(5, N, M, D, device=dev)
    gm = torch.Generator(device=dev)
    gm.manual_seed(6)
    t0 = time.perf_counter()
    eng_m = ReverseKRanksEngine.build(mu_, mi_, cfg, gm,
                                      backend=PrunedBackend("fused"),
                                      device=dev, cluster_reorder=True)
    torch.cuda.synchronize()
    build_m = time.perf_counter() - t0
    hot = mi_[int(torch.nonzero(micl == 0)[0])] * 1.2
    qs_hot = (hot[None, :] * (1.0 + 1e-3 * torch.randn(
        (B, D), generator=gm, device=dev))).contiguous()
    fused_m = ReverseKRanksEngine(eng_m.users, eng_m.rank_table, cfg,
                                  backend="fused")
    res_m = eng_m.query_batch(qs_hot, K, C)
    st = eng_m._backend.stats
    same_selection(torch, res_m, fused_m.query_batch(qs_hot, K, C),
                   "(iii) mid_mixture pruned:fused")
    qb_pm = time_ms(torch, lambda: eng_m.query_batch(qs_hot, K, C), reps=10)
    qb_fm = time_ms(torch, lambda: fused_m.query_batch(qs_hot, K, C),
                    reps=10)
    print(f"  (iii) mid_mixture (10% noise floor), build with "
          f"cluster_reorder {build_m:.3f} s; hot-cluster batch: kept union "
          f"{st.kept_union} of {st.n_blocks}, skip rate {st.skip_rate:.4f}, "
          f"kept per query {st.kept_per_query:.4f}, fallback "
          f"{st.fallback or 'none'}; selection bitwise the full scan's; "
          f"steady query_batch(B={B}) pruned:fused {qb_pm:.3f} ms, fused "
          f"{qb_fm:.3f} ms")
    if st.fallback:
        print("  finding: the mid_mixture hot batch fell back to the full "
              "scan at the default cap")
    # where the pruned query's time goes, stage by stage (CUDA events; the
    # phase A stage ends in its host sync of the keep mask)
    bk = eng_m._backend
    summ = bk.summary_for(eng_m.rank_table, eng_m.users)
    stage_a = lambda: pruning.phase_a(summ, qs_hot, k=K)[0].cpu()
    keep_np = stage_a().numpy()
    union = np.flatnonzero(keep_np.any(axis=0))
    ids_np = pruning.bucket_blocks(union, n_blocks=summ.n_blocks,
                                   min_blocks=-(-K // bk.block_size))
    ids = torch.from_numpy(ids_np).to(dev)
    valid = torch.from_numpy(np.arange(ids_np.size) < union.size).to(dev)
    keep_d = torch.from_numpy(keep_np).to(dev)
    step1 = lambda: ops.bound_ranks_batched_pruned_stored(
        eng_m.users, qs_hot, eng_m.rank_table, ids, block_n=bk.block_size)
    bounds = step1()
    t_a = time_ms(torch, stage_a, reps=10)
    t_b = time_ms(torch, step1, reps=10)
    t_c = time_ms(torch, lambda: pruning.finish_compacted(
        *bounds, ids, valid, keep_d, M, K, C, N, bk.block_size), reps=10)
    t_m = time_ms(torch, lambda: pruning.materialize(
        bounds[0], ids, keep_d, N, float(M + 2), bk.block_size), reps=10)
    t_s = time_ms(torch, lambda: query_mod.select_topk(
        *bounds, k=K, c=C, m_items=M), reps=10)
    print(f"  (iii) stages: phase A with its host sync {t_a:.3f} ms; K6 on "
          f"{ids_np.size} tiles {t_b:.3f} ms; finish_compacted {t_c:.3f} "
          f"ms, of which each of its two materialize calls {t_m:.3f} ms; "
          f"select_topk alone on the compacted arrays {t_s:.3f} ms")
    del fused_m, bounds

    # phase 7 (f) reads the pruned telemetry on this engine's state; the
    # churn of 4d publishes new tensors and leaves these as they are
    held_iii = (eng_m.users, eng_m.rank_table, qs_hot, st.skip_rate,
                st.fallback)
    # 4d. the mutable index: its own data and engines, then phase 4c's
    # reordered engines and the mid_mixture engine, all churned
    print(f"phase: mutable index, n={N} m={M} d={D} tau={TAU}, B={B} and "
          f"1, churn {CHURN}")
    t0 = time.perf_counter()
    pruned_cases = [(f"4c reordered {spec}", ReverseKRanksEngine(
        f["eng_p"].users, f["eng_p"].rank_table, f["eng_p"].config,
        items=items, positions=pos, weights=w), qs)
        for spec, f in forced.items()]
    pruned_cases.append(("4c (iii) mid_mixture, hot batch", eng_m, qs_hot))
    delta_report = mutable_index_checks(dev, pruned=pruned_cases,
                                        avoid=netflix_qids(torch, dev))
    del pruned_cases, eng_m, mu_, mi_
    print(f"  digest delta (phase 4d's f32 fused delta bounds, B={B}): "
          f"{delta_report['digest']}")
    print(f"  phase 4d: checks {''.join(delta_report['checks'])} passed, "
          f"{time.perf_counter() - t0:.1f} s")
    check(delta_report["checks"] == list("abcdefg"),
          "phase 4d did not run every check")

    # 5. kernels against plain versions on the main path's inputs, timed
    print("phase: kernels vs plain at the main path's shapes, timed")
    thr, tab = rt.thresholds, rt.table
    items_sorted, _ = rt_mod.sort_items_by_norm(items)
    samples = items_sorted[pos].contiguous()
    out = []

    def row(*args):
        out.append(kernel_record(*args))

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
        # the launches alone, outputs given (the wrapper allocates them)
        buf = torch.empty((3, N, nb), dtype=torch.float32, device=dev)
        launch_ms = time_ms(torch, lambda: masked_launch(
            ops, users, q, None, rt, None, 0, buf), reps=20)
        del buf
        print(f"  k1_bound_ranks[B={nb}]: the launches alone, outputs "
              f"given, {launch_ms:.3f} ms")
        # least bytes: U and Q once; per user, a search of the sorted
        # thresholds row and the table sectors this run's lookups touch;
        # outputs
        idx = query_mod._bucketize(thr, users @ q.T)
        table_bytes = gather_bytes(torch, idx, TAU, 4)
        k1_bytes = (4 * (N * D + nb * D) + N * search_bytes(4 * TAU, nb)
                    + table_bytes + 12 * N * nb)
        del idx
        # beside it, the bytes were a search to read only the thresholds
        # sectors around each count (the same cells as the table's): the
        # least on this grid, which K1's grid guess nears at B = 1
        near = k1_bytes - N * search_bytes(4 * TAU, nb) + table_bytes
        print(f"  k1_bound_ranks[B={nb}]: bound were the search to read only "
              f"the thresholds sectors around each count "
              f"{near / HBM_BYTES_PER_S * 1e3:.3f} ms ({near} B against "
              f"{k1_bytes} B)")
        # operations: the product's f32 FMAs as two each, plus
        # N·nb·⌈log2 τ⌉ for the search, which counts its comparisons, not
        # f32 operations; against 2·N·d·nb it does not decide the bound,
        # which the bytes set
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
    print("  K2 " + device_breakdown(
        torch, lambda: ops.build_table_rows(users, samples, w, thr), reps=5,
        top=3))
    # weights that are not all equal, so that every weight sorts with its
    # key (the count's other path); their sums are not exact in f32
    S = samples.shape[0]
    w_mixed = w * (1.0 + (torch.arange(S, device=dev) % 2) / 64.0)
    check_k2(torch, ops, ref, users, samples, w_mixed, thr,
             "Netflix, unequal weights")
    print("  K2, unequal weights: " + device_breakdown(
        torch, lambda: ops.build_table_rows(users, samples, w_mixed, thr),
        reps=5, top=3))
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
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    mm = matmul_ms(torch, users, items)
    print(f"  f32 product alone, not K3's function: torch.matmul of the "
          f"({N}, {D}) x ({D}, {M}) product, TF32 off, in user blocks of "
          f"32,768, scores written, summed over the blocks: {mm:.3f} ms "
          f"({2 * N * M * D / mm / 1e9:.1f} TFLOP/s; K3 "
          f"{2 * N * M * D / ms / 1e9:.1f} TFLOP/s)")

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
            # the wrapper's host work (checks, ‖q‖₁'s halving adds) can
            # exceed a short launch; the launches alone, for comparison
            buf = torch.empty((3, N, nb), dtype=torch.float32, device=dev)
            launch_ms = time_ms(torch, lambda: quant_launch(
                ops, (rows, uscale, uslack), q, qn, rt_s, buf), reps=20)
            del buf
            print(f"  {name}[B={nb}]: the launches alone, ‖q‖₁ and outputs "
                  f"given, {launch_ms:.3f} ms")
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

    # K6/K7 on the forced pruned engines' kept tiles (phase 4c (ii)):
    # bitwise the full scan's on the kept rows, the plain versions by the
    # rules above, the bound over the kept rows only
    for spec, name, line, source in (
            ("f32", "k6_bound_ranks_masked", 191, "user_scores.cu"),
            ("bf16", "k7_bound_ranks_bf16_masked", 460,
             "user_scores_quant.cu"),
            ("int8", "k7_bound_ranks_int8_masked", 460,
             "user_scores_quant.cu")):
        eng_p = forced[spec]["eng_p"]
        rt_s = eng_p.rank_table
        su = eng_p.users if eng_p.stored_users is None else \
            eng_p.stored_users
        summ = eng_p._backend.summary_for(rt_s, su)
        bn = eng_p._backend.block_size
        for nb in (B, 1):
            q = qs[:nb].contiguous()
            union, ids = kept_tiles(torch, np, pruning, eng_p, q)
            got = ops.bound_ranks_batched_pruned_stored(su, q, rt_s, ids,
                                                        block_n=bn)
            full = ops.bound_ranks_batched_stored(su, q, rt_s)
            ridx = pruning.row_indices(ids, bn).long()
            live = ridx < N
            for a, b_ in zip(got, full):
                check(torch.equal(a[:, live], b_[:, ridx[live]]),
                      f"{name} Netflix B={nb}: kept rows differ from the "
                      "full scan's")
            del full
            uniq = torch.from_numpy(union.astype(np.int64)).to(dev)
            g = pruning.row_indices(uniq, bn)
            g = g[g < N]
            # each kept row's column in the compacted outputs: its tile's
            # first position in the list (a duplicate holds the same values)
            pos_of = torch.full((summ.n_blocks,), ids.numel(),
                                dtype=torch.int64, device=dev).scatter_reduce(
                0, ids.long(), torch.arange(ids.numel(), device=dev), "amin")
            cols = pos_of[g // bn] * bn + g % bn
            kept = [x[:, cols].T.contiguous() for x in got]
            label = f"{name} Netflix B={nb}, {union.size} kept tiles"
            if spec == "f32":
                err = check_k1(torch, ops, ref, su[g], q, rt_s.thresholds[g],
                               rt_s.table[g], M, label, got=kept, name="K6")
                plain = lambda: ref.ref_bound_ranks_masked(
                    su, q, rt_s.thresholds, rt_s.table, M, ids, bn)
                need, flops = step1_need(torch, query_mod, ops, su[g], q,
                                         rt_s.take_rows(g))
            else:
                su_g = su.take_rows(g)
                err, _ = check_quant(torch, ops, ref, query_mod, su_g, q,
                                     rt_s.take_rows(g), label, got=kept)
                rows_, usc, usl = ops.stored_parts(su, spec)
                plain = lambda: ref.ref_bound_ranks_stored_masked(
                    rows_, usc, usl, q, query_mod.query_l1(q), rt_s, ids,
                    bn)
                need, flops = step1_need(torch, query_mod, ops, su_g, q,
                                         rt_s.take_rows(g))
            del got, kept
            # the kernel's time: its launches alone (masked_launch); the
            # wrapper's, with its synchronizing check of the ids, beside
            qn = query_mod.query_l1(q)
            buf = torch.empty((3, ids.numel() * bn, nb), dtype=torch.float32,
                              device=dev)
            ms = time_ms(torch, lambda: masked_launch(
                ops, su, q, qn, rt_s, ids, bn, buf), reps=20)
            del buf
            wrapper_ms = time_ms(
                torch, lambda: ops.bound_ranks_batched_pruned_stored(
                    su, q, rt_s, ids, block_n=bn), reps=20)
            pms = time_ms(torch, plain, reps=5)
            print(f"  {name}[B={nb}]: the wrapper, with its ids check, "
                  f"{wrapper_ms:.3f} ms")
            need += 4 * ids.numel() + 12 * ids.numel() * bn * nb
            print(f"  {name} B={nb}: {union.size} kept tiles of "
                  f"{summ.n_blocks} ({ids.numel()} launched, {g.numel()} "
                  "kept rows)")
            row(f"{name}[B={nb}]", f"src/repro/kernels/user_scores.py:{line}",
                counts_p[name], err, ms, pms, need, flops, src + source)

    # 5b. the selection kernels at both benchmark cells' shapes
    out.extend(selection_checks(dev))

    # 6. the serving path: elastic programs on CUDA graphs, MicroBatcher
    from repro_torch.core import elastic
    cap = elastic.capacity_for(N, elastic.default_tile())
    print(f"phase: serving, n={N} m={M} d={D} tau={TAU}, B={B}, elastic "
          f"tile {elastic.default_tile()}, capacity {cap}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    engines = {"f32": eng, "bf16": tier["bf16"]["eng"],
               "int8": tier["int8"]["eng"]}
    serve_report = serving_checks(dev, users=users, items=items, cfg=cfg,
                                  pos=pos, w=w, qs=qs, engines=engines)
    torch.cuda.synchronize()
    counts_e = serve_report["launches"]     # (spec, B) -> launches, (a)
    for (spec, nb), v in counts_e.items():
        check(v >= 1, f"kernel {ELASTIC_KERNEL[spec]} was not launched on "
              f"the serving path at B={nb}")
    print(f"  phase 6: checks {''.join(serve_report['checks'])} passed, "
          f"{time.perf_counter() - t0:.1f} s; peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
          f"{(torch.cuda.max_memory_allocated() - held) / 1e9:.2f} GB above "
          f"the {held / 1e9:.2f} GB held before it")
    check(serve_report["checks"] == list("abcdefg"),
          "phase 6 did not run every check")

    # the elastic entries on the padded operands at n_valid = n, beside
    # the existing entries at n
    nvt = torch.tensor([N], dtype=torch.int32, device=dev)
    for spec, name, nbs in (("f32", "k1_bound_ranks_elastic", (B, 1)),
                            ("bf16", "k4_bound_ranks_bf16_elastic", (B,)),
                            ("int8", "k5_bound_ranks_int8_elastic", (B,))):
        bk = serve_report["backends"][spec]
        bucket = next(b for b in bk._buckets.values() if b.corr is None)
        up, rp = bucket.users, bucket.rt
        eng_s = engines[spec]
        su = eng_s.users if spec == "f32" else eng_s.stored_users
        rt_s = eng_s.rank_table
        for nb in nbs:
            q = qs[:nb].contiguous()
            got = ops.bound_ranks_batched_stored(up, q, rp, nvt)
            full = ops.bound_ranks_batched_stored(su, q, rt_s)
            for a, b_ in zip(got, full):
                check(torch.equal(a[:, :N], b_),
                      f"{name} Netflix B={nb}: rows below n_valid differ "
                      "from the existing entry's")
            kept = [x[:, :N].T.contiguous() for x in got]
            label = f"{name} Netflix B={nb}, capacity {bucket.cap}"
            if spec == "f32":
                err = check_k1(torch, ops, ref, su, q, rt_s.thresholds,
                               rt_s.table, M, label, got=kept,
                               name="K1 elastic")
                plain = lambda: ref.ref_rows_past(ref.ref_bound_ranks(
                    up, q, rp.thresholds, rp.table, M), nvt, M)
            else:
                err, _ = check_quant(torch, ops, ref, query_mod, su, q, rt_s,
                                     label, got=kept)
                parts = ops.stored_parts(up, spec)
                plain = lambda: ref.ref_rows_past(ref.ref_bound_ranks_stored(
                    *parts, q, query_mod.query_l1(q), rp), nvt, M)
            del got, full, kept
            ms = time_ms(torch, lambda: ops.bound_ranks_batched_stored(
                up, q, rp, nvt), reps=20)
            ms_n = time_ms(torch, lambda: ops.bound_ranks_batched_stored(
                su, q, rt_s), reps=20)
            pms = time_ms(torch, plain, reps=3)
            print(f"  {name}[B={nb}]: {ms:.3f} ms over the capacity "
                  f"{bucket.cap} at n_valid = {N}, against {ms_n:.3f} ms of "
                  f"the existing entry over the {N} rows")
            need, flops = step1_need(torch, query_mod, ops, su, q, rt_s)
            row(f"{name}[B={nb}]", ELASTIC_REPLACES, counts_e[(spec, nb)],
                err,
                ms, pms, need + 4 + 12 * N * nb, flops,
                src + ("user_scores.cu" if spec == "f32"
                       else "user_scores_quant.cu"))
    del serve_report, engines

    # 7. durability, the maintenance loop and the auditor
    print(f"phase: durability, maintenance and the auditor, n={N} m={M} "
          f"d={D} tau={TAU}, churn {CHURN}")
    t0 = time.perf_counter()
    report7 = durability_checks(dev, users=users, items=items, cfg=cfg,
                                rt=eng.rank_table, pos=pos, w=w, qs=qs,
                                grades=grades4, pruned=held_iii,
                                avoid=netflix_qids(torch, dev))
    print(f"  phase 7: checks {''.join(report7['checks'])} passed, "
          f"{time.perf_counter() - t0:.1f} s")
    check(report7["checks"] == list("abcdef"),
          "phase 7 did not run every check")
    del report7

    # 8. row-sharded execution and the QSRP baseline
    print(f"phase: row-sharded execution and QSRP, n={N} m={M} d={D} "
          f"tau={TAU}, P={P_QUERY} (query) and {P_BUILD} (build, pruned, "
          f"ring at n'={N_CUT}) shards of one card, B={B}, k={K}")
    t0 = time.perf_counter()
    mu_, mi_, _ = mid_mixture(5, N, M, D, device=dev)
    report8 = sharded_checks(dev, users=users, items=items, cfg=cfg, pos=pos,
                             w=w, qs=qs, rt=eng.rank_table,
                             int8=(tier["int8"]["eng"].stored_users,
                                   tier["int8"]["eng"].rank_table),
                             truth=truth, exact_idx=exact_idx,
                             mid=(mu_, mi_), qs_hot=held_iii[2],
                             q1=items[QUERY_ITEM])
    del mu_, mi_
    print(f"  digest sharded (the f32 sharded query_batch, B={B}: indices "
          f"and candidate bounds): {report8['digest']}")
    print(f"  phase 8: checks {''.join(report8['checks'])} passed, "
          f"{time.perf_counter() - t0:.1f} s; {nvidia_smi_line()}")
    check(report8["checks"] == list("abcde"),
          "phase 8 did not run every check")
    del report8

    # 9. the entry points, each in a subprocess under the import blocker
    print(f"phase: the entry points (launch.serve, the MF trainer, the "
          f"examples) in subprocesses without JAX, n={N} m={M} d={D} "
          f"tau={TAU}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    report9 = entry_point_checks(dev)
    print(f"  phase 9: checks {''.join(report9['checks'])} passed, "
          f"{time.perf_counter() - t0:.1f} s; {nvidia_smi_line()}")
    check(report9["checks"] == list("abcdef"),
          "phase 9 did not run every check")
    del report9

    # 10. the LM substrate's serving path, then step 4 of serve_retrieval
    # and its kernels at gemma-2b's width
    bf16_in_f32 = not (torch.backends.cuda.matmul.
                       allow_bf16_reduced_precision_reduction)
    print(f"phase: the LM substrate's serving path (gemma-2b at its "
          f"published size, the other architectures at full width and "
          f"reduced depth), step 4 of serve_retrieval; bf16 products "
          f"reduce in f32: {bf16_in_f32}")
    check(bf16_in_f32, "bf16 products may reduce in bf16")
    torch.cuda.empty_cache()
    t10 = time.perf_counter()
    report10 = lm_checks(dev)
    check(report10["checks"] == list("abc"),
          "phase 10 did not run every check")
    out.extend(lm_kernel_rows(torch, ops, ref, query_mod, report10["c"]))
    del report10
    print(f"  phase 10: checks abc passed, {time.perf_counter() - t10:.1f} s; "
          f"{nvidia_smi_line()}")

    # 11. the LM substrate's training path
    print("phase: LM training (gemma-2b at its published size through "
          "launch.train, the step's checks at full width, one step of "
          "every architecture, kill and resume, examples.train_lm)")
    torch.cuda.empty_cache()
    t11 = time.perf_counter()
    report11 = train_checks(dev)
    check(report11["checks"] == list("abcde"),
          "phase 11 did not run every check")
    print(f"  phase 11: checks abcde passed, "
          f"{time.perf_counter() - t11:.1f} s; {nvidia_smi_line()}")

    # 12. the LM substrate's sharding: the sharded step on a 1x1 mesh
    # against the plain one, elastic restore, the dry run
    print("phase: the LM substrate's sharding (gemma-2b's sharded step on a "
          "1x1 NCCL mesh against the unsharded one, a checkpoint restored "
          "both ways, the dry run of gemma-2b's cells on the production "
          "meshes)")
    torch.cuda.empty_cache()
    t12 = time.perf_counter()
    report12 = sharded_lm_checks(dev)
    check(report12["checks"] == list("abc"),
          "phase 12 did not run every check")
    print(f"  phase 12: checks abc passed, "
          f"{time.perf_counter() - t12:.1f} s; {nvidia_smi_line()}")
    return out


if __name__ == "__main__":
    sys.exit(main())
