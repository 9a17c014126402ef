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
    KeyError;
  * elasticity — restore(shardings=...) lays every leaf out on the mesh
    and placements it is given, so a job can come back on another mesh
    shape.

Under `torch.distributed` every rank calls `save` (a DTensor leaf is
gathered whole, `full_tensor()`, a collective); rank 0 alone writes,
after a barrier, and the others wait for it at a second one.
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
from repro_torch.models.sharding import is_dtensor


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


def _rebuild(tree, prefix, get, shd=None):
    """`tree`'s structure with get(key, leaf, sharding) at each leaf;
    `shd` is None or a tree of the same structure whose leaves are
    (mesh, placements) pairs."""
    at = (lambda k: None) if shd is None else (lambda k: shd[k])
    if isinstance(tree, dict):
        return {k: _rebuild(v, prefix + (str(k),), get, at(k))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), prefix + (f".{f}",),
                                     get, at(i))
                            for i, f in enumerate(tree._fields)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, prefix + (str(i),), get, at(i))
                          for i, v in enumerate(tree))
    return get("/".join(prefix), tree, shd)


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("bf16 leaves have no numpy dtype; checkpoint "
                            "the f32 masters")
        if is_dtensor(leaf):
            leaf = leaf.full_tensor()
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def save(ckpt_dir: str, step: int, tree, metadata: Optional[dict] = None
         ) -> str:
    """Write one checkpoint atomically; returns its final path. Under
    `torch.distributed` every rank calls it (module doc)."""
    flat = {k: _numpy(v) for k, v in _paths(tree)}
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    _barrier()
    try:
        if _rank() == 0:
            _write(ckpt_dir, step, flat, metadata, final)
    finally:
        _barrier()
    return final


def _write(ckpt_dir, step, flat, metadata, final) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
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
            device=None, shardings=None) -> tuple[Any, int, dict]:
    """Load a checkpoint into `template`'s structure: a tree of tensors
    (meta tensors will do) whose shapes and dtypes the checkpoint's
    leaves must take. Every leaf lands on `device` (the CUDA card unless
    the caller passes device='cpu').

    shardings: optional tree of the template's structure whose leaves are
    (DeviceMesh, placements) pairs: every leaf becomes a DTensor on its
    mesh (each rank keeps its own slice of the whole leaf it read), which
    may have another shape than the mesh that saved it — the elastic
    restore. The mesh's device type then takes the place of `device`.
    Returns (tree, step, metadata)."""
    dev = resolve_device(device) if shardings is None else None
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    keys = set(manifest["keys"])
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        def get(key, leaf, shd):
            if key not in keys:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = npz[key.replace("/", "|")]
            want_shape = tuple(leaf.shape)
            if tuple(arr.shape) != want_shape:
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{arr.shape} vs template {want_shape}")
            if shd is None:
                return torch.from_numpy(arr).to(device=dev,
                                                dtype=leaf.dtype)
            mesh, placements = shd
            full = torch.from_numpy(arr).to(device=_mesh_device(mesh),
                                            dtype=leaf.dtype)
            return distribute_tensor(full, mesh, list(placements),
                                     src_data_rank=None)

        if shardings is not None:
            from torch.distributed.tensor import distribute_tensor
        tree = _rebuild(template, (), get, shardings)
    return tree, step, manifest["metadata"]


def _mesh_device(mesh) -> torch.device:
    """The device this rank's slices of `mesh` live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def prune_old(ckpt_dir: str, keep: int = 3) -> None:
    """Keep the newest `keep` checkpoints (preemption-safe GC); under
    `torch.distributed` rank 0 deletes and the others wait for it."""
    if _rank() != 0 or not os.path.isdir(ckpt_dir):
        _barrier()
        return
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
    _barrier()
