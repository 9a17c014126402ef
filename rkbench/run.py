"""Run one cell of the port's benchmark on the card.

    python3 rkbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints a provenance line and the cell's counts, then, as its last line
on standard output, the result object; each number compared for
`correct` goes beside its limit on the last lines of standard error and
under `checks`, the result's last key. Exits non-zero, printing no
result, without a CUDA card (or fewer than the cell asks for), without
the port (`src/repro_torch`), or when a module of JAX or of the JAX
package `repro` is loaded once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "rkbench"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

SMI_FIELDS = ("name,power.limit,power.draw,clocks.sm,clocks.max.sm,"
              "clocks.mem,temperature.gpu,driver_version")


def nvidia_smi() -> dict | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={SMI_FIELDS}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    keys = SMI_FIELDS.split(",")
    return {"cards": [dict(zip(keys, (v.strip() for v in line.split(","))))
                      for line in out]}


def source_digest() -> str:
    """sha256 of the port's sources, which stands for the commit in a
    checkout that is not a git repository."""
    h = hashlib.sha256()
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*")):
        if path.suffix in (".py", ".cu", ".cuh") and path.is_file():
            h.update(str(path.relative_to(ROOT)).encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def commit() -> str | None:
    try:
        # no search above the checkout, which may sit in another repository
        env = dict(os.environ, GIT_CEILING_DIRECTORIES=str(ROOT.parent))
        return subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                              env=env, capture_output=True, text=True,
                              timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every kernel cache at a fixed path inside the checkout, read at the
    # first CUDA use, so that only a checkout's first run builds (the
    # port's own kernels go to build/repro_torch)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")

    from rkbench import harness, manifest
    cell = manifest.workload(manifest.load_manifest(), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"rkbench: needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              "; no result", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (the code under test; IEEE f32 on)
    torch.set_num_threads(2)
    torch.cuda.init()
    imports_s = time.perf_counter() - T_START
    print(json.dumps({"provenance": {
        "device": torch.cuda.get_device_name(), "count": cell["chips"],
        "nvidia_smi": nvidia_smi(), "torch": torch.__version__,
        "cuda": torch.version.cuda, "python": sys.version.split()[0],
        "commit": commit(), "src_digest": source_digest(),
        "seed": args.seed, "seconds": args.seconds, "trace": args.trace,
        "imports_and_cuda_init_s": imports_s}}),
        flush=True)
    result = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace), T_START,
        log=lambda obj: print(json.dumps(obj), flush=True))
    # after the window, the reference and the readers: what the port or
    # anything else loaded in this process
    bad = harness.forbidden_modules()
    if bad:
        print(f"rkbench: modules of JAX or the JAX package loaded: {bad}; "
              "no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
