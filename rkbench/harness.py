"""One run of a cell: set-up, the measured window, the comparison with the
plain reference, and the result.

Set-up makes every input on the device from the seed (`inputs`,
`loadgen`), loads the port's kernels, builds the engine
(`ReverseKRanksEngine.build` on the configuration's backend, given
Algorithm 1's sample) and warms up the cell's one batch shape. The window
drives `engine.query_batch` through the traffic mix's loop. After it the
peak device memory is read, the engine is freed, and the reference
(`references/<name>.py`) answers a sample of the window's batches, drawn
from the seed, to decide `correct`.

The numbers compared, and how, are the reference module's (`compare`);
the configuration's `correct` gives each its limit. A configuration's
`build_options` go to `build` as they are (none in the cells so far).
"""
from __future__ import annotations

import contextlib
import gc
import sys
import time

import numpy as np
import torch

from rkbench import counts, inputs, loadgen, manifest, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
COUNT_BATCHES = 4           # traced batches whose lookups the counts read


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (`repro_torch` is not `repro`)."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ------------------------------------------------------------ programs
def port_program(eng, k: int, c: float):
    """The timed path: `engine.query_batch`, its answer's ids and
    estimated ranks."""
    def run(qs):
        res = eng.query_batch(qs, k, c)
        return res.indices, res.est_rank
    return run


def reference_program(ref, k: int, c: float):
    """A reference engine in the program's place (the control)."""
    return lambda qs: ref.query(qs, k, c)


def faulty(program, fault: str, n: int):
    """`program` broken underneath, for the test that sees `correct` fail:
    "stale" answers each batch with the previous batch's answer (a step
    that leaves its state unchanged); "half_batch" computes the first
    half of the batch and answers the second half with it; "answer"
    alters one answer a query where it is produced (its last user id)."""
    if fault == "stale":
        last = []

        def run(qs):
            out = program(qs)
            prev = last[0] if last else out
            last[:] = [out]
            return prev
    elif fault == "half_batch":
        def run(qs):
            h = qs.shape[0] // 2
            idx, est = program(qs[:h])
            return torch.cat([idx, idx]), torch.cat([est, est])
    elif fault == "answer":
        def run(qs):
            idx, est = program(qs)
            idx = idx.clone()
            idx[:, -1] = (idx[:, -1] + 1) % n
            return idx, est
    else:
        raise ValueError(f"unknown fault {fault!r}")
    return run


# -------------------------------------------------------------- set-up
def load_kernels(device) -> bool:
    """Build (first run in a checkout) or load the port's CUDA kernels;
    True when this run compiled them."""
    if torch.device(device).type != "cuda":
        return False
    from repro_torch.kernels import _build
    info = _build.build_all()
    return any(v["seconds"] > 0 for v in info.values())


def build_engine(cfg: dict, data: dict, device):
    from repro_torch.core.engine import ReverseKRanksEngine
    from repro_torch.core.types import RankTableConfig
    rt_cfg = RankTableConfig(tau=cfg["tau"], omega=cfg["omega"], s=cfg["s"],
                             storage_dtype=cfg["storage"])
    return ReverseKRanksEngine.build(
        data["users"], data["items"], rt_cfg, None, backend=cfg["backend"],
        device=device, positions=data["positions"], weights=data["weights"],
        **cfg.get("build_options", {}))


def setup(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """Inputs, the engine and its program, warmed up on the cell's shape;
    the seconds of each stage under `stages`."""
    marks = [time.perf_counter()]

    def mark():
        sync(device)
        marks.append(time.perf_counter())
        return marks[-1] - marks[-2]

    data = inputs.make(cfg, seed, device)
    qv = loadgen.query_pool(traffic, data, seed)
    stages = {"inputs_s": mark()}
    compiled = load_kernels(device)
    stages["kernels_s"] = mark()
    eng = build_engine(cfg, data, device)
    stages["build_s"] = mark()
    program = port_program(eng, traffic["k"], traffic["c"])
    warm_up(program, qv, traffic["warmup_batches"])
    stages["warmup_s"] = mark()
    return {"data": data, "qv": qv, "eng": eng, "program": program,
            "build_s": stages["build_s"], "stages": stages,
            "index_bytes": eng.memory_bytes(), "compiled": compiled}


def warm_up(program, qv: torch.Tensor, batches: int) -> None:
    for i in range(batches):
        idx, est = program(qv[i % qv.shape[0]])
        idx.cpu(), est.cpu()


# ----------------------------------------------------------- comparison
def sample_batches(done: int, want: int, seed: int) -> list[int]:
    """`want` of the window's `done` batches, drawn from the seed."""
    g = torch.Generator()
    g.manual_seed(inputs.subseed(seed, inputs.CHECK))
    return sorted(torch.randperm(done, generator=g)[:want].tolist())


def checks(numbers: dict, limits: dict) -> dict:
    """Each number compared beside its limit (a number passes at or below
    it)."""
    return {name: {"value": numbers[name], "limit": limit}
            for name, limit in limits.items()}


def reference_for(cfg: dict, data: dict, variant: str = "exact"):
    mod = manifest.reference(cfg["reference"])
    return mod.Reference(data["users"], data["items"], data["positions"],
                         data["weights"], cfg, variant=variant)


# --------------------------------------------------------------- metrics
def per_layer_context(cfg: dict, traffic: dict, summary: dict, ref,
                      qv: torch.Tensor, state: dict) -> dict:
    """What the per-layer readers read: the traced slice's reduction, the
    least time of a batch and of its step 1 (the table sectors from the
    reference's lookups of the first traced batches), the build's time
    and the index's bytes."""
    n, d, tau = cfg["n_users"], cfg["d"], cfg["tau"]
    nb, k = traffic["batch"], traffic["k"]
    st = manifest.storage(cfg["storage"])
    table = []
    for b in range(min(COUNT_BATCHES, qv.shape[0])):
        idx_lo, idx_hi = ref.lookup_indices(qv[b])
        table.append(counts.gather_bytes(idx_hi, tau, st.CELL_BYTES, idx_lo))
    table_bytes = float(np.mean(table))
    return {"trace": summary, "cfg": cfg, "traffic": traffic,
            "least_query_s": counts.least_seconds(*st.query(
                n, d, tau, nb, k, table_bytes)),
            "least_step1_s": counts.least_seconds(*st.step1(
                n, d, tau, nb, table_bytes)),
            "build_s": state["build_s"], "index_bytes": state["index_bytes"]}


@contextlib.contextmanager
def program_spans(on: bool):
    """The program's own spans (`repro_torch.obs.trace`) as profiler
    ranges while `on`, so that the trace holds device time under them."""
    if not on:
        yield
        return
    from repro_torch.obs import trace as spans
    spans.enable(profiler=True)
    try:
        yield
    finally:
        spans.disable()


def end_to_end(window: dict, batch: int, peak: int, setup_s: float) -> dict:
    return {"queries_per_s": window["answered_in_window"] * batch
            / window["window_s"],
            "query_p95_ms": float(np.percentile(window["latencies_s"], 95))
            * 1e3,
            "device_peak_gb": peak / 1e9,
            "setup_s": setup_s}


# ------------------------------------------------------------------ run
def run_cell(cell_name: str, seed: int, seconds: float, traced: bool,
             t_start: float, log=print) -> dict:
    """One run of the cell `cell_name` of `BENCHMARK.json` on the card."""
    man = manifest.load_manifest()
    cell = manifest.workload(man, cell_name)
    return run(man, cell, manifest.config(cell["config"]),
               manifest.traffic(cell["traffic"]), seed, seconds, traced,
               t_start, "cuda", log)


def run(man: dict, cell: dict, cfg: dict, traffic: dict, seed: int,
        seconds: float, traced: bool, t_start: float, device,
        log=print) -> dict:
    """One run of `cell` (configuration `cfg`, mix `traffic`) on `device`;
    `log` receives the earlier lines (the provenance is the caller's).
    Returns the result object, the checks last."""
    cuda = torch.device(device).type == "cuda"
    state = setup(cfg, traffic, seed, device)
    tracer = trace.Tracer() if traced else None
    loop = manifest.loop(traffic["loop"])
    ref_mod = manifest.reference(cfg["reference"])
    setup_s = time.perf_counter() - t_start
    with program_spans(traced):
        window = loop.run(state, traffic, seconds, tracer)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    summary = trace.reduce(tracer) if traced else None
    del state["eng"], state["program"], tracer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = reference_for(cfg, state["data"])
    batches = sample_batches(len(window["answers"]),
                             traffic["check_batches"], seed)
    numbers = ref_mod.compare(ref, state, window, batches, traffic)
    chk = checks(numbers, cfg["correct"])
    attempted = len(window["answers"]) * traffic["batch"]
    log({"counts": {
        "batches": len(window["answers"]), "queries_attempted": attempted,
        "queries_failed": 0,
        "answered_in_window": window["answered_in_window"],
        "latency_ms_q": [1e3 * float(x) for x in np.quantile(
            window["latencies_s"], [0.05, 0.5, 0.95, 0.99])],
        "latency_ms_by_fifth": [1e3 * float(np.mean(part)) for part in
                                np.array_split(window["latencies_s"], 5)],
        "queries_compared": numbers["queries"],
        "setup_compiled": state["compiled"], "setup_s": setup_s,
        **state["stages"], "index_bytes": state["index_bytes"],
        **{key: numbers[key] for key in (
            "est_err_q", "pick_gap_q", "est_off", "pick_off",
            "not_in_ref_topk")}}})
    if traced and summary:
        log({"trace": {key: summary[key] for key in (
            "batches", "window_s", "busy_s", "kernel_s", "span_device_s",
            "span_calls", "unheld_s")}})
    name = cell["name"]
    if traced:
        ctx = per_layer_context(cfg, traffic, summary, ref, state["qv"],
                                state)
        metrics = {}
        for m in manifest.metrics_for(man, name, "per_layer"):
            value = manifest.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = end_to_end(window, traffic["batch"], peak, setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in manifest.metrics_for(man, name, "end_to_end")}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    if traced and summary:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
    result = {"correct": all(v["value"] <= v["limit"]
                             for v in chk.values()),
              "attempted": attempted, "failed": 0, "metrics": metrics,
              "device": dev}
    if traced and summary:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = chk
    return result
