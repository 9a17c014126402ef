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
--layers, a --d-model width and a vocabulary of at most 8,192). The
mesh and its sharding rules come with the port's sharding.
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
from repro_torch.models.model import Model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import AdamWConfig, adamw_init, \
    cosine_schedule
from repro_torch.train.trainer import make_train_step


def run_training(cfg, *, steps: int, global_batch: int, seq_len: int,
                 ckpt_dir: str | None = None, ckpt_every: int = 50,
                 microbatches: int = 1, lr: float = 3e-4,
                 log_every: int = 10, seed: int = 0, device=None):
    """Train `cfg` from seeded parameters (or the newest checkpoint under
    `ckpt_dir`) up to `steps` on `device` (the CUDA card unless the
    caller passes device='cpu'). Returns (params, the losses of the steps
    this call ran, as Python floats)."""
    dev = resolve_device(device)
    model = Model(cfg)
    opt = AdamWConfig(lr=lr)
    sched = lambda s: cosine_schedule(s, warmup=max(steps // 20, 10),
                                      total=steps)
    pipe = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=seq_len,
                                        global_batch=global_batch,
                                        seed=seed), device=dev)
    step_fn = make_train_step(model, opt, microbatches=microbatches,
                              schedule=sched)

    start = 0
    if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        tpl = {"params": model.abstract_params(),
               "opt": adamw_init(model.abstract_params())}
        state, start, _ = ckpt.restore(ckpt_dir, tpl, device=dev)
        params, opt_state = state["params"], state["opt"]
        print(f"resumed from step {start}")
    else:
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        params = model.init_params(g, dev)
        opt_state = adamw_init(params)

    losses, step_times = [], []
    for step in range(start, steps):
        t0 = time.time()
        batch = pipe.batch_at(step)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        dt = time.time() - t0
        step_times.append(dt)
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d}  loss {losses[-1]:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"{dt*1e3:.0f} ms/step", flush=True)
        # straggler heartbeat: a step >5× the running median is flagged
        # (on a real cluster this triggers the preemption/replace path)
        if len(step_times) > 5 and dt > 5 * float(
                np.median(step_times[-50:])):
            print(f"[heartbeat] straggler step {step}: {dt:.2f}s vs "
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
