"""End-to-end training run: train a ~100M-parameter dense LM for a few
hundred steps on the deterministic synthetic pipeline, with
checkpointing and resume.

    python -m repro_torch.examples.train_lm            # ~100M, 200 steps
    python -m repro_torch.examples.train_lm --tiny     # CI-speed

Counterpart of the reference's `examples/train_lm.py`, on the CUDA card;
`main(device="cpu", tiny=True)` runs it on the CPU. The same
`run_training()` drives the full configs through `python -m
repro_torch.launch.train --arch <id> --full-config`.
"""
import argparse
import dataclasses
import tempfile
import time

from repro_torch.configs import get_config
from repro_torch.launch.train import run_training


def config(tiny: bool = False):
    """(cfg, steps, global batch, sequence length) of the example."""
    base = get_config("granite-3-8b")
    if tiny:
        cfg = dataclasses.replace(
            base, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
            head_dim=32, d_ff=512, vocab=2048, remat="none")
        return cfg, 30, 4, 64
    # ~100M params: 12L × d512 (GQA 8/2) × ff2048, 32k vocab
    cfg = dataclasses.replace(
        base, n_layers=12, d_model=512, n_heads=8, n_kv_heads=2,
        head_dim=64, d_ff=2048, vocab=32_768, remat="none")
    return cfg, 200, 8, 256


def main(*, device=None, tiny: bool = False, steps=None) -> dict:
    cfg, default_steps, gb, seq = config(tiny)
    steps = steps or default_steps

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        _, losses = run_training(cfg, steps=steps, global_batch=gb,
                                 seq_len=seq, ckpt_dir=ckpt_dir,
                                 ckpt_every=max(steps // 4, 10), lr=1e-3,
                                 log_every=max(steps // 20, 1),
                                 device=device)
    wall = time.perf_counter() - t0
    drop = losses[0] - losses[-1]
    print(f"\nloss {losses[0]:.3f} → {losses[-1]:.3f} "
          f"(drop {drop:.3f} over {steps} steps, "
          f"{wall * 1e3 / steps:.1f} ms/step with checkpoints)")
    assert drop > 0.3, "training did not learn — investigate"
    print("OK")
    return {"losses": losses, "drop": drop, "ms_per_step": wall * 1e3 / steps}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true", help="CI-speed run")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    main(device=args.device, tiny=args.tiny, steps=args.steps)
