"""Fault-tolerant checkpointing: atomic, step-tagged, in the reference's
on-disk layout.

Counterpart of the reference's `train/checkpoint.py`. Layout:

    <dir>/step_<N>/
        manifest.json  — keys, shapes, dtypes, step, user metadata
        arrays.npz     — flattened leaves keyed by escaped path
    <dir>/LATEST       — atomically updated pointer file

Keys are the reference's: the path of a leaf joined by "/" as
`jax.tree_util` prints it — a dict's key, a list's index, and a
NamedTuple's field with a leading dot (`params/segments/0/b0/attn/wq`,
`opt/.mu/embed/tok`, `opt/.step`) — and written into the npz with "/" as
"|". So each package restores the other's checkpoint of a train state.

Guarantees (tests/test_torch_checkpoint.py):
  * atomicity — a checkpoint is visible only after os.replace of its
    directory and then of the LATEST pointer; a killed writer leaves no
    partial step visible, and a torn pointer is ignored;
  * resume-exactness — restore() and the counter-based data pipeline
    replay reproduce the uninterrupted run bitwise;
  * validation — a shape mismatch raises ValueError, a missing leaf
    KeyError.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


def _paths(tree, prefix=()):
    """(path, leaf) of every leaf, in the reference's key order (dict
    keys sorted, as `jax.tree_util` flattens them)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _paths(getattr(tree, f), prefix + (f".{f}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _rebuild(tree, prefix, get):
    if isinstance(tree, dict):
        return {k: _rebuild(v, prefix + (str(k),), get)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), prefix + (f".{f}",),
                                     get) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, prefix + (str(i),), get)
                          for i, v in enumerate(tree))
    return get("/".join(prefix), tree)


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("bf16 leaves have no numpy dtype; checkpoint "
                            "the f32 masters")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree, metadata: Optional[dict] = None
         ) -> str:
    """Write one checkpoint atomically; returns its final path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = {k: _numpy(v) for k, v in _paths(tree)}
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=f".tmp_step_{step}_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k.replace("/", "|"): v for k, v in flat.items()})
        manifest = {
            "step": int(step),
            "keys": sorted(flat.keys()),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": {k: str(v.dtype) for k, v in flat.items()},
            "metadata": metadata or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)                      # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # atomic LATEST pointer
    ptr_tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(f"step_{step:08d}")
    os.replace(ptr_tmp, os.path.join(ckpt_dir, "LATEST"))
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    path = os.path.join(ckpt_dir, name)
    if not os.path.exists(os.path.join(path, "manifest.json")):
        return None                                  # torn pointer: ignore
    return int(name.split("_")[1])


def restore(ckpt_dir: str, template, step: Optional[int] = None,
            device=None) -> tuple[Any, int, dict]:
    """Load a checkpoint into `template`'s structure: a tree of tensors
    (meta tensors will do) whose shapes and dtypes the checkpoint's
    leaves must take. Every leaf lands on `device` (the CUDA card unless
    the caller passes device='cpu'). Returns (tree, step, metadata)."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    keys = set(manifest["keys"])
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        def get(key, leaf):
            if key not in keys:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = npz[key.replace("/", "|")]
            want_shape = tuple(leaf.shape)
            if tuple(arr.shape) != want_shape:
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{arr.shape} vs template {want_shape}")
            return torch.from_numpy(arr).to(
                device=dev, dtype=leaf.dtype)

        tree = _rebuild(template, (), get)
    return tree, step, manifest["metadata"]


def prune_old(ckpt_dir: str, keep: int = 3) -> None:
    """Keep the newest `keep` checkpoints (preemption-safe GC)."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
