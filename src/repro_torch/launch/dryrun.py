"""Multi-pod dry run: trace every (architecture × input shape × mesh) cell
on fake tensors — nothing allocated, nothing moved — and record the memory
and the three-term roofline of one step per device.

    python -m repro_torch.launch.dryrun --arch gemma-2b --both-meshes \\
        --out dryrun.json
    python -m repro_torch.launch.roofline_report dryrun.json --md

Counterpart of the reference's `launch/dryrun.py`, which lowers and
compiles XLA programs on 512 forced host devices. Here `main()` starts
`torch.distributed`'s fake process group ("fake" backend, `FakeStore`) at
the mesh's world size, this process being rank 0 of it, and builds the
production mesh over it (`launch.mesh.make_production_mesh`, CPU type).
`dryrun_cell` then makes the cell's arguments as fake DTensors with the
model's placements (bf16 weights for serving cells, f32 masters with FSDP
for training, as the reference does), runs the step once under
`launch.roofline.measure` and writes the reference's record:
`lower_s` is the time to lay out the fake arguments, `compile_s` the
step's traced run; `arg_bytes` the sum of this rank's shards of the
arguments, `temp_bytes` the peak of the local tensors the step allocates
(alive at once), `out_bytes` this rank's shards of what it returns.

Start it as a process of its own: the fake group takes the place of a
real one for the whole process. `--engine` adds the row-sharded reverse
k-ranks engine's cells at `--dataset`'s scale (`dryrun_engine`).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.paper_engine import DATASETS
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.config import SHAPE_CELLS, cell_applicable
from repro_torch.models.model import Model, make_prefill_step, \
    make_serve_step
from repro_torch.models.sharding import distribute, rules_for
from repro_torch.models.transformer import tree_map
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.trainer import make_train_step

CELLS = {c.name: c for c in SHAPE_CELLS}


def mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.shape)


def start_fake_group(world_size: int) -> None:
    """Make this process rank 0 of a fake process group of `world_size`
    ranks (the previous group, if any, is destroyed first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _fake(meta, dtype, dev):
    import torch
    return torch.empty(meta.shape, dtype=dtype, device=dev)


def dryrun_cell(arch_id: str, cell_name: str, *, multi_pod: bool = False,
                mesh=None, cfg=None, verbose: bool = True) -> dict:
    """Trace one cell on `mesh` (default: the production mesh of
    `multi_pod`, over the running process group); returns its record.
    `cfg` replaces `get_config(arch_id)` (a test's reduced config)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = cfg or get_config(arch_id)
    cell = CELLS[cell_name]
    ok, reason = cell_applicable(cfg, cell)
    rec = {"arch": arch_id, "cell": cell_name,
           "mesh": mesh_name(mesh) if mesh is not None
           else ("2x16x16" if multi_pod else "16x16")}
    if not ok:
        rec.update(status="SKIP", reason=reason)
        return rec

    t0 = time.time()
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size()
    dev = torch.device(mesh.device_type)
    is_train = cell.kind == "train"
    rules = rules_for(cfg, mesh, batch_size=cell.global_batch,
                      fsdp=is_train)
    model = Model(cfg)
    abstract = model.abstract_params()
    tokens = cell.global_batch * (1 if cell.is_decode else cell.seq_len)
    with FakeTensorMode():
        # train: f32 master weights + FSDP on the expert axis; serve: bf16
        # weights, no FSDP (weights stay resident, no per-step gather)
        wdt = lambda p: (torch.bfloat16 if not is_train
                         and p.dtype == torch.float32 else p.dtype)
        params = tree_map(lambda p, s: distribute(_fake(p, wdt(p), dev),
                                                  mesh, s),
                          abstract, model.param_specs(rules))
        bspecs = model.batch_specs(rules, cell)
        batch = {k: distribute(_fake(v, v.dtype, dev), mesh, bspecs[k])
                 for k, v in model.input_specs(cell).items()}
        if cell.kind == "train":
            opt = adamw_init(params)
            opt = opt._replace(step=distribute(opt.step, mesh, ()))
            fn = make_train_step(model, AdamWConfig(), rules)
            args = (params, opt, batch)
            mf = RL.model_flops_train(cfg, abstract, tokens)
        elif cell.kind == "prefill":
            fn = make_prefill_step(model, rules)
            args = (params, batch)
            mf = RL.model_flops_train(cfg, abstract, tokens) / 3.0
        else:                                   # decode
            cache = model.abstract_cache(cell.global_batch, cell.seq_len)
            cspecs = model.cache_specs(rules, cell.global_batch,
                                       cell.seq_len)
            cache = {"segments": tree_map(
                lambda c, s: distribute(_fake(c, c.dtype, dev), mesh, s),
                cache["segments"], cspecs["segments"]),
                # one new token against a cache holding S-1 tokens
                "len": cell.seq_len - 1}
            fn = make_serve_step(model, rules)
            args = (params, cache, batch["tokens"])
            mf = RL.model_flops_decode(cfg, abstract, tokens)
        arg_bytes = sum(RL._nbytes(t) for t in RL.local_tensors(args))
        t_lower = time.time() - t0
        counts = RL.measure(fn, *args)
        t_compile = time.time() - t0 - t_lower
        out_bytes = sum(RL._nbytes(t) for t in RL.local_tensors(counts.out))
    roof = RL.terms(counts, chips=chips, model_flops=mf)
    rec.update(
        status="OK",
        chips=chips,
        lower_s=round(t_lower, 1), compile_s=round(t_compile, 1),
        bytes_per_device=int(counts.peak_bytes + arg_bytes),
        temp_bytes=int(counts.peak_bytes),
        arg_bytes=int(arg_bytes),
        out_bytes=int(out_bytes),
        roofline=roof.as_dict(),
    )
    if verbose:
        print(f"[{rec['mesh']}] {arch_id} × {cell_name}: OK  "
              f"flops/dev={roof.flops:.3e} hbm/dev={roof.hbm_bytes:.3e} "
              f"coll/dev={roof.coll_bytes:.3e} → {roof.bottleneck}-bound  "
              f"(trace {rec['compile_s']}s, "
              f"args/dev {rec['arg_bytes']/2**30:.2f} GiB, "
              f"temp/dev {rec['temp_bytes']/2**30:.2f} GiB)", flush=True)
    return rec


def _engine_record(dataset, name, chips, counts, arg_bytes, coll,
                   model_flops, verbose) -> dict:
    """One engine cell's record (the reference's keys) from what one
    shard does: `counts` already per shard, `coll` {kind: (bytes,
    moves)}."""
    detail = {k: int(coll.get(k, (0, 0))[0]) for k in RL._COLLECTIVES}
    detail["total"] = sum(detail[k] for k in RL._COLLECTIVES)
    detail["counts"] = {k: int(coll.get(k, (0, 0))[1])
                        for k in RL._COLLECTIVES}
    roof = RL.terms(RL.StepCounts(flops=counts.flops,
                                  hbm_bytes=counts.hbm_bytes,
                                  coll_detail=detail,
                                  peak_bytes=counts.peak_bytes, out=None),
                    chips=chips, model_flops=model_flops)
    rec = {"arch": f"engine/{dataset.name}", "cell": name,
           "mesh": f"flat{chips}", "status": "OK", "chips": chips,
           "bytes_per_device": int(counts.peak_bytes + arg_bytes),
           "temp_bytes": int(counts.peak_bytes), "arg_bytes": int(arg_bytes),
           "roofline": roof.as_dict()}
    if verbose:
        print(f"[flat{chips}] engine/{dataset.name} × {name}: OK  "
              f"flops/dev={roof.flops:.3e} coll/dev={roof.coll_bytes:.3e} "
              f"→ {roof.bottleneck}-bound", flush=True)
    return rec


def dryrun_engine(*, multi_pod: bool = True, dataset=None, shards=None,
                  k: int = 10, c: float = 2.0, verbose: bool = True
                  ) -> list:
    """The row-sharded reverse k-ranks engine (`core.distributed`) at a
    dataset's scale (default AMAZON_K) on a flat mesh of the production
    mesh's world size (512 or 256 shards; `shards` overrides): `build`
    (Algorithm 1, `build_sharded`), `query` (one query through the tree
    merge, `make_query_fn`) and `refine_ring` (`ring_exact_ranks`), each
    traced on fake tensors, n and m padded up to multiples of the shards.

    The port's engine is one controller over a tuple of devices, not a
    process group: the shards run one after another on a mesh that
    repeats one (fake) device. Per device: build's and query's counted
    ops, bytes and peak over the shards (every shard does the same work;
    the lead's gathers and merge are spread over them); the ring's from
    one shard's step times its P steps. Collective bytes are sized from
    the moves the engine makes, as the results each shard takes part in:
    build gathers the item norms and the packed table rows to the lead
    (all-gather) and sends the samples to every shard (collective-
    permute); the query's `COLLECTIVES` steps gather the (2, B, k) order
    statistics and the (B, k) candidates (all-gather) and send R↓_k /
    R↑_k back (collective-permute); the ring passes P - 1 item blocks
    from shard to shard (collective-permute) and gathers the ranks."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs.paper_engine import AMAZON_K, DEFAULT_TABLE
    from repro_torch.core import distributed as D
    from repro_torch.core.types import RankTable
    from repro_torch.kernels import ops
    dataset = dataset or AMAZON_K
    P = shards or (512 if multi_pod else 256)
    n = -(-dataset.n_users // P) * P
    m = -(-dataset.n_items // P) * P
    d = dataset.d
    cfg = DEFAULT_TABLE
    S = cfg.omega * cfg.s
    mesh = ("cpu",) * P
    f32 = 4
    recs = []
    with FakeTensorMode():
        users, items = torch.empty(n, d), torch.empty(m, d)
        pos, w = torch.zeros(S, dtype=torch.int64), torch.empty(S)
        q = torch.empty(d)
        per = lambda x: x / P

        counts = RL.measure(lambda: D.build_sharded(users, items, cfg, pos,
                                                    w, mesh))
        table = sum(RL._nbytes(t) for t in RL.local_tensors(
            [counts.out.thresholds, counts.out.table]))
        counts = RL.StepCounts(per(counts.flops), per(counts.hbm_bytes),
                               {}, per(counts.peak_bytes), None)
        recs.append(_engine_record(
            dataset, "build", P, counts, (n + m) * d * f32 / P,
            {"all-gather": (m * f32 + table, 3),      # norms, 2 fields
             "collective-permute": ((S * d + S + 1) * f32, 3)},
            2.0 * n * S * d, verbose))

        rt = RankTable(thresholds=torch.empty(n, cfg.tau),
                       table=torch.empty(n, cfg.tau), m=m)
        fn = D.make_query_fn(mesh, k=k, n=n, c=c)
        D.reset_collective_counts()
        counts = RL.measure(lambda: fn(rt, users, q))
        steps = dict(D.COLLECTIVES)
        counts = RL.StepCounts(per(counts.flops), per(counts.hbm_bytes),
                               {}, per(counts.peak_bytes), None)
        recs.append(_engine_record(
            dataset, "query", P, counts, (n * (d + 2 * cfg.tau)) * f32 / P,
            {"all-gather": (steps["gather_stats"] * 2 * k * P * f32
                            + steps["gather_candidates"] * k * P
                            * (3 * f32 + 8),
                            steps["gather_stats"]
                            + steps["gather_candidates"]),
             "collective-permute": (steps["send_stats"] * 2 * f32,
                                    steps["send_stats"])},
            2.0 * n * d, verbose))

        u_s, b_s = users[:n // P].contiguous(), items[:m // P].contiguous()
        counts = RL.measure(lambda: ops.exact_ranks(u_s, b_s, q))
        counts = RL.StepCounts(counts.flops * P, counts.hbm_bytes * P, {},
                               counts.peak_bytes, None)
        recs.append(_engine_record(
            dataset, "refine_ring", P, counts, (n + m) * d * f32 / P,
            {"collective-permute": ((P - 1) * (m // P) * d * f32, P - 1),
             "all-gather": (n * f32, 1)},
            2.0 * n * m * d, verbose))
    return recs


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", default=None, choices=ARCH_IDS)
    ap.add_argument("--shape", default=None, choices=list(CELLS))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (arch × shape) cell")
    ap.add_argument("--engine", action="store_true",
                    help="paper-engine cells at dataset scale")
    ap.add_argument("--dataset", default="amazon-k",
                    choices=list(DATASETS))
    ap.add_argument("--out", default=None, help="JSON output path")
    args = ap.parse_args(argv)

    records = []
    meshes = ([False, True] if args.both_meshes else [args.multi_pod])
    if args.engine:
        for mp in meshes:
            records += dryrun_engine(multi_pod=mp,
                                     dataset=DATASETS[args.dataset])
    archs = ARCH_IDS if args.all or args.arch is None else [args.arch]
    shapes = list(CELLS) if args.all or args.shape is None else [args.shape]
    if not args.engine or args.all or args.arch or args.shape:
        for mp in meshes:
            start_fake_group(512 if mp else 256)
            mesh = make_production_mesh(multi_pod=mp)
            for a in archs:
                for s in shapes:
                    try:
                        records.append(dryrun_cell(a, s, multi_pod=mp,
                                                   mesh=mesh))
                    except Exception as e:  # a failure is a bug: record
                        traceback.print_exc()
                        records.append({"arch": a, "cell": s,
                                        "mesh": "2x16x16" if mp
                                        else "16x16",
                                        "status": "FAIL", "error": repr(e)})
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    n_ok = sum(r["status"] == "OK" for r in records)
    n_skip = sum(r["status"] == "SKIP" for r in records)
    n_fail = sum(r["status"] == "FAIL" for r in records)
    print(f"\ndry-run: {n_ok} OK, {n_skip} SKIP, {n_fail} FAIL "
          f"/ {len(records)} cells")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
