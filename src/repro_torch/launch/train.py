"""Training launcher: `python -m repro_torch.launch.train --arch <id> [...]`.

Counterpart of `repro/launch/train.py` on one device, with the same flags
and output lines, plus `--device` (default: the CUDA card, which must
exist; `--device cpu` runs on the CPU, and is the only way to it) and
`--log-every`. It draws the parameters from seed 0 (or resumes from the
newest checkpoint under --ckpt-dir), runs the train step with the
checkpoint cadence, and logs a heartbeat that flags straggler steps::

    python -m repro_torch.launch.train --arch granite-3-8b --steps 50
    python -m repro_torch.launch.train --arch gemma-2b --full-config \\
        --global-batch 2 --seq-len 2048 --steps 12

Without --full-config the architecture is reduced (`configs.reduced`,
--layers, a --d-model width and a vocabulary of at most 8,192).

`run_training(..., mesh=)` takes a `torch.distributed` DeviceMesh with
("data", "model") or ("pod", "data", "model") axes, as
`launch.mesh.make_production_mesh` builds one: every rank of the process
group calls it with the same arguments. The parameters and moments are
laid out by `Model.param_specs` under `rules_for(cfg, mesh,
batch_size=global_batch)`, the step count replicated, each batch by
`Model.batch_specs`; a checkpoint restores onto the mesh through
`checkpoint.restore(shardings=)`, whatever mesh shape saved it. Only rank
0 prints.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models.config import ShapeCell
from repro_torch.models.model import Model
from repro_torch.models.sharding import distribute, placements_for, \
    rules_for
from repro_torch.models.transformer import tree_map
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import AdamWConfig, OptState, \
    adamw_init, cosine_schedule
from repro_torch.train.trainer import make_train_step


def _mesh_device(mesh, device) -> torch.device:
    """The device of this rank's slices of `mesh`; `device`, when given,
    must be of the mesh's type."""
    dev = ckpt._mesh_device(mesh)
    if device is not None and resolve_device(device).type != dev.type:
        raise ValueError(f"device {device!r} is not the mesh's "
                         f"{mesh.device_type!r}")
    return dev


def run_training(cfg, *, steps: int, global_batch: int, seq_len: int,
                 ckpt_dir: str | None = None, ckpt_every: int = 50,
                 mesh=None, microbatches: int = 1, lr: float = 3e-4,
                 log_every: int = 10, seed: int = 0, device=None,
                 record: dict | None = None):
    """Train `cfg` from seeded parameters (or the newest checkpoint under
    `ckpt_dir`) up to `steps` on `device` (the CUDA card unless the
    caller passes device='cpu'), or on `mesh` (module doc). Returns
    (params, the losses of the steps this call ran, as Python floats);
    with a mesh the parameters are DTensors.

    record: a dict that, when given, gets three lists with an entry for
    each step this call runs: `step_s`, its wall time up to the loss read
    on the host (which waits for the device); `call_s`, the part of it
    until the step's call returned (the host's share, the batch
    included); `grad_norm`, the step's global grad norm."""
    dev = resolve_device(device) if mesh is None else \
        _mesh_device(mesh, device)
    model = Model(cfg)
    rules = rules_for(cfg, mesh, batch_size=global_batch) if mesh else None
    opt = AdamWConfig(lr=lr)
    sched = lambda s: cosine_schedule(s, warmup=max(steps // 20, 10),
                                      total=steps)
    pipe = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=seq_len,
                                        global_batch=global_batch,
                                        seed=seed), device=dev)
    step_fn = make_train_step(model, opt, rules, microbatches=microbatches,
                              schedule=sched)
    say = print if ckpt._rank() == 0 else (lambda *a, **k: None)
    if mesh is not None:
        pspecs = model.param_specs(rules)
        bspecs = model.batch_specs(rules, ShapeCell(
            "run", "train", seq_len, global_batch))

    start = 0
    if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        tpl = {"params": model.abstract_params(),
               "opt": adamw_init(model.abstract_params())}
        shardings = None
        if mesh is not None:
            pshard = tree_map(lambda _, s: (mesh, placements_for(mesh, s)),
                              tpl["params"], pspecs)
            shardings = {"params": pshard, "opt": OptState(
                mu=pshard, nu=pshard, step=(mesh, placements_for(mesh, ())))}
        state, start, _ = ckpt.restore(ckpt_dir, tpl, device=dev,
                                       shardings=shardings)
        params, opt_state = state["params"], state["opt"]
        say(f"resumed from step {start}")
    else:
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        params = model.init_params(g, dev)
        if mesh is not None:
            params = tree_map(lambda p, s: distribute(p, mesh, s), params,
                              pspecs)
        opt_state = adamw_init(params)
        if mesh is not None:
            opt_state = opt_state._replace(
                step=distribute(opt_state.step, mesh, ()))

    losses, step_times = [], []
    if record is not None:
        record.update(step_s=step_times, call_s=[], grad_norm=[])
    for step in range(start, steps):
        t0 = time.perf_counter()
        batch = pipe.batch_at(step)
        if mesh is not None:
            batch = {k: distribute(v, mesh, bspecs[k])
                     for k, v in batch.items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        t_call = time.perf_counter() - t0
        losses.append(float(metrics["loss"]))
        dt = time.perf_counter() - t0
        step_times.append(dt)
        if record is not None:
            record["call_s"].append(t_call)
            record["grad_norm"].append(float(metrics["grad_norm"]))
        if step % log_every == 0 or step == steps - 1:
            say(f"step {step:5d}  loss {losses[-1]:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"{dt*1e3:.0f} ms/step", flush=True)
        # straggler heartbeat: a step >5× the running median is flagged
        # (on a real cluster this triggers the preemption/replace path)
        if len(step_times) > 5 and dt > 5 * float(
                np.median(step_times[-50:])):
            say(f"[heartbeat] straggler step {step}: {dt:.2f}s vs "
                  f"median {np.median(step_times[-50:]):.2f}s")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, step + 1,
                      {"params": params, "opt": opt_state})
            ckpt.prune_old(ckpt_dir, keep=3)
    if ckpt_dir:
        ckpt.save(ckpt_dir, steps, {"params": params, "opt": opt_state})
    return params, losses


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--full-config", action="store_true",
                    help="use the published config")
    ap.add_argument("--d-model", type=int, default=256,
                    help="reduced-config width override")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--log-every", type=int, default=10,
                    help="print a step line every N steps")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "runs on the CPU)")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = reduced(cfg, layers=args.layers)
        cfg = dataclasses.replace(
            cfg, d_model=args.d_model, d_ff=args.d_model * 4,
            vocab=min(cfg.vocab, 8192))
    _, losses = run_training(
        cfg, steps=args.steps, global_batch=args.global_batch,
        seq_len=args.seq_len, ckpt_dir=args.ckpt_dir, lr=args.lr,
        microbatches=args.microbatches, log_every=args.log_every,
        device=args.device)
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")


if __name__ == "__main__":
    main()
