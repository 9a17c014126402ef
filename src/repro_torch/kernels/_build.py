"""Build and load the CUDA kernels: nvcc → shared library → ctypes.

Each `csrc/<name>.cu` compiles on its own into
`build/repro_torch/<name>-<hash>.so` at the root of the checkout, with a
plain C interface and no PyTorch headers, so a build takes seconds. The
hash covers every source and the flags, so an edited source rebuilds.
All sources compile in parallel, one nvcc each, at the first CUDA use
(never at import). A failed build raises with nvcc's stderr.

Flags: `sm_90a` for Hopper; no `--use_fast_math`, so `expf`, divisions
and denormals stay IEEE; `--fmad=false`, so no a*b+c of the plain
version is contracted into an FMA that PyTorch's elementwise kernels do
not do (the kernels write their FMAs as `fmaf`, which this leaves alone).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("user_scores", "user_scores_quant", "table_build", "exact_rank")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
# symbol → argtypes; every entry returns the cudaError_t of its launch
SIGNATURES = {
    "user_scores": {
        "k1_bound_ranks": (P, P, P, P, P, P, P, I, I, I, I, I, F, P),
        "k6_bound_ranks_masked": (P, P, P, P, P, P, P, P, I, I, I, I, I, F,
                                  I, I, P),
        "k1_launch_config": (I, I, I, I, P)},
    "user_scores_quant": {
        "k4_bound_ranks_bf16": (P, I, P, P, P, P, P, P, P, P, I, I, I, I, I,
                                F, F, F, P),
        "k5_bound_ranks_int8": (P, I, P, P, P, P, P, P, P, P, P, P, P, P, P,
                                I, I, I, I, I, F, F, F, F, P),
        "k7_bound_ranks_bf16_masked": (P, I, P, P, P, P, P, P, P, P, P, I, I,
                                       I, I, I, F, F, F, I, I, P),
        "k7_bound_ranks_int8_masked": (P, I, P, P, P, P, P, P, P, P, P, P, P,
                                       P, P, P, I, I, I, I, I, F, F, F, F, I,
                                       I, P),
        "quant_launch_config": (I, I, I, I, I, I, P)},
    "table_build": {"k2_plan": (I, I, I, P),
                    "k2_table_build": (P, P, P, P, P, P, I, I, I, I, I,
                                       P),
                    "k2_launch_config": (I, I, I, P)},
    "exact_rank": {"k3_exact_ranks": (P, P, P, P, P, I, I, I, P),
                   "k3_workspace_floats": (I, I, P),
                   "k3_launch_config": (I, P)},
}

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_INFO: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "are built on the machine with the card")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict[str, dict]:
    """Compile every source that has no library for the current hash,
    all at once, and load them. Returns {name: {path, seconds, ptxas}}."""
    if len(_LIBS) == len(SOURCES):
        return BUILD_INFO
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = _digest()
    procs = {}
    for name in SOURCES:
        out = BUILD_DIR / f"{name}-{tag}.so"
        if out.exists():
            BUILD_INFO[name] = {"path": str(out), "seconds": 0.0,
                                "ptxas": "(cached)"}
            continue
        tmp = out.with_name(f"{name}-{tag}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {name}.cu "
                            f"(exit {proc.returncode}):\n{stderr}{stdout}")
            continue
        os.replace(tmp, out)
        BUILD_INFO[name] = {"path": str(out),
                            "seconds": time.perf_counter() - t0,
                            "ptxas": stderr.strip()}
    if failures:
        raise RuntimeError("\n".join(failures))
    for name in SOURCES:
        lib = ctypes.CDLL(BUILD_INFO[name]["path"])
        for symbol, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = (ctypes.c_int,)
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return BUILD_INFO


def call(name: str, symbol: str, *args) -> None:
    """Launch `symbol` of library `name`; raise on a refused or failed
    launch (the cudaGetLastError the C entry returns)."""
    build_all()
    lib = _LIBS[name]
    rc = getattr(lib, symbol)(*args)
    if rc != 0:
        msg = lib.repro_error_string(rc).decode()
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc} ({msg})")
