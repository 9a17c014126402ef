"""Serving driver for the paper's engine: build a rank-table index over
user/item embeddings and serve c-approximate reverse k-ranks queries
ONLINE through the async micro-batching scheduler, reporting the §5
quality metrics against the exact oracle.

Counterpart of `repro/launch/serve.py`, with the same flags and output
lines, plus `--device` (default: the CUDA card, which must exist;
`--device cpu` runs the plain PyTorch path, and is the only way to it)::

    python -m repro_torch.launch.serve --n 20000 --m 8000 [--backend fused] [--mf]

Queries are submitted one at a time to `repro_torch.serve.MicroBatcher`,
which coalesces them into --max-batch-sized ticks dispatched through
`engine.dispatch_batch_at` (one rank-table pass per tick); --max-wait-ms
is the latency-vs-throughput knob (how long a partial tick waits to
fill). --backend accepts any registry name (dense|fused|sharded|pruned)
plus wrapped specs such as "cached:fused" (within-tick dedupe + cross-tick
per-query LRU; see repro_torch.serve.cache) or "elastic:fused" (one
captured CUDA graph per capacity bucket; see repro_torch.core.elastic).
"sharded" runs over every visible card (`distributed.flat_mesh`), or the
CPU with --device cpu. --max-depth bounds the queue (fail-fast
back-pressure). --no-eval-exact skips the oracle pass.

--update-stream replays a live item-churn workload WHILE serving: every
--update-every submissions a batch of --insert-batch fresh items is
inserted and --delete-batch live items are deleted (absorbed by the delta
buffer, `repro_torch.index`), with a background `MaintenanceLoop`
rebuilding and hot-swapping the index whenever the delta ratio or
stale-sample budget is exceeded — queries keep flowing through every swap
(each tick pins one epoch; `TickStats.epoch` shows the generations
served). The oracle pass then scores post-churn queries against the
FINAL live item set.

Random draws come from torch generators (the numbers differ from the
reference's `jax.random` draws, the distributions do not): the
embeddings (or the MF ratings and trainer) from --seed, the build's
samples from seed 1, the query ids from seed 2, the churn's vectors from
--seed + 17; the churn's deletions from `np.random.default_rng(--seed +
17)`, as in the reference.

Telemetry (`repro_torch.obs`)
-----------------------------
The whole serving path publishes to the process-global metrics registry.
To watch a live run, expose the scrape endpoint and point a browser (or
Prometheus) at it::

    python -m repro_torch.launch.serve --n 20000 --m 8000 \\
        --backend cached:pruned:dense --update-stream \\
        --metrics-port 9100 --audit-fraction 0.05 --stats-every 200

    curl localhost:9100/metrics          # Prometheus text exposition
    curl localhost:9100/metrics.json     # same registry as JSON

Key series: `serve_request_latency_ms` (histogram; p50/p99 in the JSON
snapshot), `serve_queue_depth` / `serve_rejected_total` (back-pressure),
`cache_hits_total` / `cache_misses_total`, `prune_skip_rate`,
`query_compiled_programs` (flat slope in steady state = no capture
storm), and `maintenance_rebuilds_total` / `maintenance_build_ms`.

--audit-fraction > 0 starts the online quality auditor
(`repro_torch.obs.audit`): that fraction of served queries is re-scored
EXACTLY against the snapshot it was served from, on a background thread
(K3 on a CUDA stream of its own). Read the verdict from the gauges
`audit_overall_ratio` / `audit_accuracy` (rolling §5 criteria over the
audit window — the overall-ratio staying within the measured envelope
means the c-contract holds in production) and `audit_bound_width` (mean
certified r↑−r↓ slack of selected users). --metrics-json PATH dumps the
final registry snapshot to a file; --trace turns on `repro_torch.obs.
trace` spans (per-tick/per-phase timing in `trace.spans()`; disabled by
default — the hot path only pays one flag check).

Ops runbook (fault tolerance)
-----------------------------
--deadline-ms D      every submission carries a D-millisecond deadline:
                     requests that expire in the queue are SHED before
                     occupying a tick slot (their futures raise
                     `DeadlineExceeded`), keeping tail latency bounded
                     under overload instead of serving everyone late.
                     Watch `serve_rejected_total{reason="deadline"}` and
                     the `exp` field of the stats line.
--degrade            arm the certified degrade ladder
                     (`repro_torch.serve.degrade`): under sustained queue
                     pressure (depth ≥ --degrade-high for consecutive
                     ticks) the scheduler steps DOWN — 1: pruned
                     backends stop their dense fallback; 2: the
                     effective c widens (bounds still certified, the
                     auditor judges at the widened contract); 3:
                     cache-only serving (misses shed) — and back UP with
                     hysteresis once depth ≤ --degrade-low. The current
                     rung is the `serve_degrade_level` gauge; every
                     answer remains a certified (r↓, r↑) result — the
                     contract is RELAXED EXPLICITLY, never silently
                     violated.
--persist-dir PATH   crash-safe durability (`repro_torch.index.persist`):
                     an atomic checksummed spill at startup and at every
                     rebuild, plus a per-mutation fsynced WAL between
                     spills. Recovery after a crash:
                     `ReverseKRanksEngine.restore(PATH)` — bitwise the
                     state at the durable point on the device type that
                     spilled, `PersistError` means rebuild from the
                     master copy. A WAL write failure degrades
                     durability to the last spill (counted by
                     `persist_wal_errors_total`), never takes serving
                     down.
Signals              SIGTERM/SIGINT request GRACEFUL shutdown: the
                     submit loop stops, in-flight futures drain for at
                     most --drain-s seconds (whatever is still queued
                     past the drain deadline is shed with reason
                     "shutdown"), a final snapshot spill lands in
                     --persist-dir, and the process exits 0.
Fault injection      set REPRO_FAULTS="site:mode[:rate[:max_fires
                     [:latency_ms]]],..." (+ REPRO_FAULTS_SEED) before
                     launch to chaos-test any site in
                     `repro_torch.serve.faults.SITES`. The fault sweep of
                     the reference's `benchmarks/perf_engine.py --faults`
                     waits for the port's benchmark.

Thread health: `maintenance_thread_alive` / `audit_thread_alive` are
callback gauges — 0 at scrape time means the background thread died (a
traceback was logged once); `maintenance_consecutive_failures` returning
to 0 after a rebuild failure means the loop recovered on its own.

Ops runbook (overlapped pipeline)
---------------------------------
--pipeline-depth N   how many dispatched ticks may be in flight at once
                     (default 2, double-buffered): the scheduler cuts
                     and launches tick t+1 while tick t's results are
                     still on the device; a separate completion stage
                     waits on the tick's CUDA event off the dispatch
                     path and resolves futures from there. Queries stay
                     host-resident from submit to batch assembly (one
                     H2D copy per tick, on the dispatch stream), so
                     `submit` never touches the device; under a caching
                     backend an exact LRU hit resolves AT ADMISSION
                     without occupying a queue or tick slot
                     (`serve_admission_hits_total`). Results are
                     bit-identical at every depth — 1 is the synchronous
                     schedule (stop-and-wait), worth choosing where
                     there is no transfer latency to hide (the CPU);
                     ≥ 2 pays off where dispatch and D2H are genuinely
                     asynchronous (the card).
Saturation           the offered-load ramp that finds a host's
                     throughput knee (the reference's
                     `benchmarks/perf_engine.py --serve --saturate`)
                     waits for the port's benchmark; during a live run
                     watch `serve_inflight_ticks` (gauge),
                     `serve_transfer_ms` (the completion stage's wait for
                     the D2H copy) and the `ovl` overlap-efficiency
                     field of the stats line.
"""
from __future__ import annotations

import argparse
import json
import signal
import threading
import time

import numpy as np
import torch

from repro_torch.core import metrics
from repro_torch.core.backends import available_backends
from repro_torch.core.distributed import flat_mesh
from repro_torch.core.engine import ReverseKRanksEngine
from repro_torch.core.exact import exact_ranks
from repro_torch.core.query import smallest_k
from repro_torch.core.types import QueryResult, RankTableConfig
from repro_torch.data.mf import MFConfig, embeddings, train_mf
from repro_torch.data.pipeline import synthetic_embeddings, \
    synthetic_ratings
from repro_torch.device import resolve_device
from repro_torch.index import IndexPersister, MaintenanceLoop, \
    MaintenancePolicy
from repro_torch.obs import registry as obs
from repro_torch.obs import trace
from repro_torch.obs.audit import QualityAuditor
from repro_torch.serve import (DeadlineExceeded, DegradeController,
                               DegradePolicy, MicroBatcher, QueueFull,
                               SchedulerClosed)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--m", type=int, default=8_000)
    ap.add_argument("--d", type=int, default=200)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--c", type=float, default=2.0)
    ap.add_argument("--tau", type=int, default=500)
    ap.add_argument("--omega", type=int, default=10)
    ap.add_argument("--s", type=int, default=64)
    ap.add_argument("--storage", default="f32",
                    choices=("f32", "bf16", "int8"),
                    help="storage spec for users/thresholds/table: f32 "
                         "exact; bf16/int8 quantized with certified bound "
                         "widening")
    ap.add_argument("--queries", type=int, default=50)
    ap.add_argument("--backend", default="dense",
                    help="query-execution backend: one of "
                         f"{available_backends()} or a wrapped spec like "
                         "'cached:fused' (see repro_torch.core.backends)")
    ap.add_argument("--max-batch", type=int, default=16,
                    help="scheduler tick size (the padded query_batch "
                         "shape)")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="latency/throughput knob: how long a partial tick "
                         "waits for more queries before dispatching")
    ap.add_argument("--max-depth", type=int, default=None,
                    help="admission bound: submits beyond this queue depth "
                         "fail fast with QueueFull (default: unbounded)")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="ticks allowed in flight at once: 1 = synchronous "
                         "stop-and-wait, 2 = double-buffered overlap of "
                         "dispatch and completion (default)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline: queued requests past it "
                         "are shed (DeadlineExceeded) instead of served "
                         "late (default: none)")
    ap.add_argument("--degrade", action="store_true",
                    help="arm the certified degrade ladder under "
                         "sustained overload (see module docstring)")
    ap.add_argument("--degrade-high", type=int, default=32,
                    help="queue depth at/above which the ladder steps "
                         "down (after a dwell of consecutive ticks)")
    ap.add_argument("--degrade-low", type=int, default=4,
                    help="queue depth at/below which it steps back up")
    ap.add_argument("--persist-dir", default=None, metavar="PATH",
                    help="crash-safe durability: spill + WAL under PATH; "
                         "recover with ReverseKRanksEngine.restore(PATH)")
    ap.add_argument("--drain-s", type=float, default=5.0,
                    help="graceful-shutdown bound: how long SIGTERM/"
                         "SIGINT waits for queued requests before "
                         "shedding the remainder")
    ap.add_argument("--update-stream", action="store_true",
                    help="replay streaming item inserts/deletes while "
                         "serving, with background rebuild + hot-swap")
    ap.add_argument("--update-every", type=int, default=16,
                    help="queries between update batches")
    ap.add_argument("--insert-batch", type=int, default=8)
    ap.add_argument("--delete-batch", type=int, default=4)
    ap.add_argument("--rebuild-delta-ratio", type=float, default=0.05,
                    help="maintenance policy: rebuild past this |delta|/m")
    ap.add_argument("--rebuild-stale-frac", type=float, default=0.02,
                    help="maintenance policy: rebuild past this tombstoned-"
                         "sample weight fraction (rank-error budget)")
    ap.add_argument("--kernels", action="store_true",
                    help="deprecated alias for --backend fused")
    ap.add_argument("--mf", action="store_true",
                    help="produce embeddings with the MF trainer "
                         "(repro_torch.data.mf)")
    ap.add_argument("--mf-epochs", type=int, default=5)
    ap.add_argument("--n-ratings", type=int, default=200_000)
    ap.add_argument("--eval-exact", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="score against the exact oracle "
                         "(--no-eval-exact to skip)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve /metrics (Prometheus text) and "
                         "/metrics.json on this port (0 = ephemeral)")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write the final registry snapshot to PATH")
    ap.add_argument("--audit-fraction", type=float, default=0.0,
                    help="fraction of served queries shadow-sampled by "
                         "the online quality auditor (exact re-scoring "
                         "on a background thread; 0 disables)")
    ap.add_argument("--stats-every", type=int, default=0,
                    help="print a one-line serving stats summary every N "
                         "submissions (0 disables)")
    ap.add_argument("--trace", action="store_true",
                    help="record repro_torch.obs trace spans for every "
                         "tick/phase (off by default; tiny per-tick cost)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card, "
                         "which must exist; 'cpu' runs the plain PyTorch "
                         "path)")
    return ap


def _device_sync(dev: torch.device) -> None:
    """Wait for all work on the card. Only before `MicroBatcher` starts:
    once its thread may capture an elastic program into a CUDA graph, a
    device-wide synchronize would wait on the capturing stream and fail
    the capture (`core/engine.py::_sync`)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_embeddings(args):
    """(users, items) on the run's device: MF embeddings (d + 2 columns)
    from synthetic ratings with --mf, else synthetic embeddings."""
    dev = resolve_device(args.device)
    if args.mf:
        ii, jj, rr = synthetic_ratings(args.seed, args.n, args.m,
                                       n_obs=args.n_ratings, device=dev)
        cfg = MFConfig(d=args.d, epochs=args.mf_epochs)
        t0 = time.time()
        state, losses = train_mf(args.seed, args.n, args.m, ii, jj, rr, cfg,
                                 device=dev)
        wall = time.time() - t0
        print(f"MF losses: {losses[0]:.4f} → {losses[-1]:.4f}")
        print(f"  MF: {cfg.epochs} epoch(s) of {args.n_ratings // cfg.batch:,}"
              f" steps in {wall:.2f}s ({wall / max(cfg.epochs, 1):.2f} "
              f"s/epoch); losses {losses}")
        return embeddings(state)
    return synthetic_embeddings(args.seed, args.n, args.m, args.d,
                                device=dev)


def build_engine(args, users, items, *, positions=None, weights=None
                 ) -> ReverseKRanksEngine:
    """Algorithm 1 on the embeddings' device, timed to the table's last
    byte; samples drawn from seed 1 unless `positions`/`weights` are
    given. Prints the `build:` line."""
    cfg = RankTableConfig(tau=args.tau, omega=args.omega, s=args.s,
                          storage_dtype=args.storage)
    backend = "fused" if args.kernels else args.backend
    dev = users.device
    mesh = (flat_mesh(device=dev) if "sharded" in backend.split(":")
            else None)
    t0 = time.time()
    eng = ReverseKRanksEngine.build(users, items, cfg, 1, backend=backend,
                                    device=dev, positions=positions,
                                    weights=weights, mesh=mesh)
    _device_sync(dev)
    print(f"build: {time.time()-t0:.2f}s  "
          f"index {eng.memory_bytes()/2**20:.1f} MiB "
          f"(n={args.n:,} m={args.m:,} d={args.d})")
    return eng


def serve(args, eng: ReverseKRanksEngine, qs: torch.Tensor
          ) -> tuple[list, bool]:
    """The online phase: warm-up, persistence, maintenance, auditor and
    degrade ladder, then every query of `qs` submitted one at a time to a
    MicroBatcher (with churn under --update-stream), a graceful stop on
    SIGTERM/SIGINT, the final spill, and the report lines. Returns
    ([(query index, host QueryResult)], whether a signal stopped it)."""
    dev = eng.users.device
    # warm-up (builds the padded tick shape's program), then the async
    # serving loop: every query is SUBMITTED individually; the
    # MicroBatcher coalesces them into --max-batch ticks, waiting at most
    # --max-wait-ms to fill.
    B = max(1, min(args.max_batch, args.queries))
    eng.query_batch(qs[:B], k=args.k, c=args.c)
    _device_sync(dev)
    qs_host = qs.cpu().numpy()      # submit keeps queries host-resident

    persister = None
    if args.persist_dir:
        persister = IndexPersister(args.persist_dir)
        eng.attach_persister(persister)
        print(f"persistence: spill + WAL under {args.persist_dir} "
              f"(recover with ReverseKRanksEngine.restore(...))")
    maint = None
    if args.update_stream:
        maint = MaintenanceLoop(
            eng, policy=MaintenancePolicy(
                max_delta_ratio=args.rebuild_delta_ratio,
                max_stale_fraction=args.rebuild_stale_frac),
            poll_ms=10.0)
    auditor = None
    if args.audit_fraction > 0:
        auditor = QualityAuditor(eng, fraction=args.audit_fraction,
                                 seed=args.seed)
    degrade = None
    if args.degrade:
        degrade = DegradeController(
            DegradePolicy(high_depth=args.degrade_high,
                          low_depth=args.degrade_low),
            backend=eng._backend)      # cache auto-discovered for rung 3

    # graceful shutdown: first SIGTERM/SIGINT stops the submit loop; the
    # scheduler then drains for at most --drain-s and sheds the rest with
    # reason "shutdown"; a final spill lands before exit 0
    stop = threading.Event()

    def _on_signal(signum, frame):
        if not stop.is_set():
            print(f"\nsignal {signal.Signals(signum).name}: draining "
                  f"(bounded {args.drain_s:.0f}s), then exiting 0",
                  flush=True)
        stop.set()

    previous = {sig: signal.signal(sig, _on_signal)
                for sig in (signal.SIGTERM, signal.SIGINT)}

    churn = torch.Generator(device=dev)
    churn.manual_seed(args.seed + 17)
    rng = np.random.default_rng(args.seed + 17)
    try:
        with MicroBatcher(eng, max_batch=B, max_wait_ms=args.max_wait_ms,
                          max_depth=args.max_depth,
                          auditor=auditor, degrade=degrade,
                          pipeline_depth=args.pipeline_depth) as mb:
            t0 = time.time()
            futs, accepted = [], []
            for i, q in enumerate(qs_host):
                if stop.is_set():
                    break
                if args.stats_every and i and i % args.stats_every == 0:
                    line = f"  [{i}/{args.queries}] {mb.stats()}"
                    if auditor is not None and auditor.scored:
                        line += (f"  audit ratio "
                                 f"{auditor.overall_ratio:.3f} "
                                 f"acc {auditor.accuracy:.3f}")
                    print(line, flush=True)
                if (args.update_stream and i
                        and i % args.update_every == 0):
                    # live churn: fresh items in, random live items out —
                    # absorbed by the delta buffer while futures resolve;
                    # the maintenance loop hot-swaps rebuilds in the
                    # background when the policy triggers.
                    eng.insert_items(torch.randn(
                        (args.insert_batch, eng.d), generator=churn,
                        device=dev, dtype=torch.float32))
                    live = eng.live_item_ids()
                    drop = rng.choice(live, size=min(args.delete_batch,
                                                     live.size - 1),
                                      replace=False)
                    eng.delete_items(drop)
                try:
                    futs.append(mb.submit(q, args.k, args.c,
                                          deadline_ms=args.deadline_ms))
                    accepted.append(i)
                except (QueueFull, DeadlineExceeded):
                    pass        # fail-fast back-pressure; counted in stats
            # pair each resolved result with ITS query index; shed
            # futures (deadline, shutdown drain, degrade-level-3 misses)
            # raise typed errors and are counted, never torn. A signal —
            # whether it landed during submission or while waiting here —
            # triggers ONE bounded drain: queued requests past --drain-s
            # are shed with reason "shutdown" (close is idempotent; the
            # context manager's second close is a no-op).
            results, shed, drained = [], 0, False
            for j, f in enumerate(futs):
                if stop.is_set() and not drained:
                    mb.close(drain_s=args.drain_s)
                    drained = True
                try:
                    results.append((accepted[j], f.result()))
                except (QueueFull, DeadlineExceeded, SchedulerClosed):
                    shed += 1
            elapsed = time.time() - t0
            st = mb.stats()
            # dispatched ticks only: the terminal record of a drain that
            # shed requests pins no snapshot (epoch None)
            epochs = sorted({t.epoch for t in mb.tick_log
                             if t.epoch is not None})
    finally:
        if maint is not None:
            maint.close()
        if persister is not None:
            # final durable point: mutations since the last spill were
            # already WAL-durable; this collapses them into one spill
            try:
                persister.spill(eng.current_snapshot(),
                                next_item_id=eng._next_item_id,
                                generator_state=eng._generator_state)
            except OSError:
                print("  WARNING: final spill failed; the WAL still "
                      "holds the mutations since the last spill")
            persister.close()
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    print(f"serve: {elapsed/max(len(results), 1)*1e3:.2f} ms/query wall "
          f"({eng.backend_name} backend, max_batch={B}, "
          f"max_wait_ms={args.max_wait_ms})")
    print(f"  ticks: {st}" + (f"  shed futures: {shed}" if shed else ""))
    if degrade is not None and degrade.transitions:
        print(f"  degrade ladder: level now {degrade.level}, "
              f"transitions {degrade.transitions}")
    if args.update_stream:
        print(f"  update stream: final epoch {eng.epoch}, "
              f"{len(maint.rebuilds)} rebuild(s), epochs served {epochs}, "
              f"delta now: {eng.delta_stats()}")
        for r in maint.rebuilds:
            print(f"    rebuild {r.epoch_before}->{r.epoch_after} "
                  f"[{r.reason}] build {r.build_s:.2f}s "
                  f"swap {r.swap_s*1e3:.1f}ms")
    if auditor is not None:
        auditor.flush(timeout=60.0)
        print(f"  audit: {auditor.scored} scored "
              f"(fraction {args.audit_fraction})  rolling overall-ratio "
              f"{auditor.overall_ratio:.4f}  accuracy "
              f"{auditor.accuracy:.4f}  bound-width "
              f"{auditor.bound_width:.2f}")
        auditor.close()
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump({"unix_time": time.time(),
                       "metrics": obs.get_default().snapshot()},
                      f, indent=2, default=str)
        print(f"  metrics snapshot → {args.metrics_json}")
    return results, stop.is_set()


def evaluate(args, eng: ReverseKRanksEngine, users, items, qs, results
             ) -> tuple[list, list]:
    """The §5 grading against the exact oracle (K3 on the card): the
    first 20 served results, or under --update-stream a fresh pass of the
    first 20 queries against the FINAL live item set. Prints the
    `accuracy` line; returns the per-query accuracies and ratios."""
    # update-stream results span epochs; score POST-CHURN queries
    # against the FINAL live item set (a fresh engine pass, so every
    # scored result was computed on the state it is judged against).
    eval_items = eng.live_items() if args.update_stream else items
    if args.update_stream:
        n_eval = min(args.queries, 20)
        post = eng.query_batch(qs[:n_eval], args.k, args.c)
        eval_pairs = [(qs[i], QueryResult(*(x[i] for x in post)))
                      for i in range(n_eval)]
    else:
        # pair each served result with ITS query (back-pressure,
        # deadlines, or degrade sheds may have dropped some)
        n_eval = min(len(results), 20)
        eval_pairs = [(qs[i0], r) for i0, r in results[:n_eval]]
    accs, ratios = [], []
    for q_i, r in eval_pairs:
        truth = exact_ranks(users, eval_items, q_i)
        # `reverse_k_ranks`'s selection over these ranks, without a
        # second oracle pass
        ex_idx = smallest_k(truth, args.k).cpu().numpy()
        truth = truth.cpu().numpy()
        got = r.indices.cpu().numpy()
        accs.append(metrics.accuracy(got, ex_idx, truth, args.c))
        ratios.append(metrics.overall_ratio(got, ex_idx, truth))
    print(f"accuracy {np.mean(accs):.4f}  overall-ratio "
          f"{np.mean(ratios):.4f}  (k={args.k}, c={args.c}"
          f"{', post-churn state' if args.update_stream else ''})")
    return accs, ratios


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.kernels and args.backend != "dense":
        ap.error("--kernels is a deprecated alias for --backend fused; "
                 f"it cannot be combined with --backend {args.backend}")
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        ap.exit(1, f"{ap.prog}: error: {e} (here: --device cpu)\n")

    if args.trace:
        trace.enable()
    if args.metrics_port is not None:
        srv = obs.start_http_server(args.metrics_port)
        host, port = srv.server_address[:2]
        print(f"metrics: http://{host}:{port}/metrics  (+ /metrics.json)",
              flush=True)

    users, items = build_embeddings(args)
    eng = build_engine(args, users, items)
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    qs = items[torch.randint(items.shape[0], (args.queries,), generator=g,
                             device=dev)]
    results, stopped = serve(args, eng, qs)
    if stopped:
        print("shutdown complete (drained, final state spilled); exit 0")
        return
    if args.eval_exact:
        evaluate(args, eng, users, items, qs, results)


if __name__ == "__main__":
    main()
