"""The readings that the limits of `correct` are set from, on the card.

    python3 rkbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--seconds 2] [--control-seeds 3]

For each seed, in one process: the program's window as a run drives it
(set-up, warm-up, `--seconds` of the traffic mix's loop), each fault of
`harness.faulty` in a window of its own on the same engine, then, with
the engine freed, the reference's comparison of each; on the first
`--control-seeds` seeds also the control, the reference in the
configuration's lower precision (`control`) put in the program's place
for a window. One JSON line a seed and side, with the numbers compared
and the quantiles behind them. Not run by the benchmark's own runs.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

FAULTS = ("stale", "half_batch", "answer")


def readings(cfg: dict, traffic: dict, seed: int, seconds: float,
             control: bool, device, emit) -> None:
    from rkbench import harness, manifest
    loop = manifest.loop(traffic["loop"])
    k, c = traffic["k"], traffic["c"]
    t0 = time.perf_counter()
    state = harness.setup(cfg, traffic, seed, device)
    setup_s = time.perf_counter() - t0
    wins = {"program": loop.run(state, traffic, seconds)}
    for fault in FAULTS:
        wins[f"fault:{fault}"] = loop.run(
            dict(state, program=harness.faulty(state["program"], fault,
                                               cfg["n_users"])),
            traffic, seconds)
    del state["eng"], state["program"]
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref_mod = manifest.reference(cfg["reference"])
    ref = harness.reference_for(cfg, state["data"])
    ref_build_s = time.perf_counter() - t0
    if control:
        low = harness.reference_for(cfg, state["data"], cfg["control"])
        wins[f"control:{cfg['control']}"] = loop.run(
            dict(state, program=harness.reference_program(low, k, c)),
            traffic, seconds)
        del low
    for side, win in wins.items():
        batches = harness.sample_batches(len(win["answers"]),
                                         traffic["check_batches"], seed)
        t0 = time.perf_counter()
        numbers = ref_mod.compare(ref, state, win, batches, traffic)
        harness.sync(device)
        emit({"seed": seed, "side": side, "batches": len(win["answers"]),
              "ms_per_batch": 1e3 * seconds / max(1, len(win["answers"])),
              "compare_s": time.perf_counter() - t0,
              "ref_build_s": ref_build_s, "setup_s": setup_s, **numbers})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    from rkbench import manifest
    import repro_torch  # noqa: F401  (the code under test; IEEE f32 on)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    cell = manifest.workload(manifest.load_manifest(), args.workload)
    cfg = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        readings(cfg, traffic, seed, args.seconds, i < args.control_seeds,
                 "cuda", lambda obj: print(json.dumps(obj), flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
