"""Production mesh construction and the H100's data-sheet constants.

A FUNCTION (not a module-level constant) so importing this module never
touches a process group: the dry run starts its fake group at the mesh's
world size first, unit tests start none.

`H100_SXM` holds the constants the roofline divides by (NVIDIA's data
sheet, SXM part, dense rates, at the full 700 W power limit). The
collective term divides by `ib_bw`, the InfiniBand bandwidth a GPU has
(one 400 Gb/s NDR port per GPU, 50 GB/s), not by NVLink's: a node holds
8 H100s, so the production meshes' 16-way model axis spans two nodes, and
a ring over it crosses InfiniBand, the slowest link, on every step. A
model axis of at most 8 inside one node would run at `nvlink_bw` (900
GB/s per GPU in both directions together, 450 GB/s each way).
"""
from __future__ import annotations

H100_SXM = {
    "peak_bf16_flops": 989e12,     # dense bf16 tensor-core FLOP/s per GPU
    "hbm_bw": 3.35e12,             # HBM3 bytes/s per GPU
    "nvlink_bw": 450e9,            # NVLink 4 bytes/s per GPU, each way
    "ib_bw": 50e9,                 # InfiniBand NDR bytes/s per GPU
}


def make_production_mesh(*, multi_pod: bool = False):
    """16×16 single-pod (256 GPUs) or 2×16×16 multi-pod (512 GPUs) over
    the default process group, whose world size must be the mesh's. The
    mesh's device type follows the group's backend: "cuda" under NCCL,
    "cpu" under gloo or the dry run's fake group (which moves and
    allocates nothing)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def dp_size(mesh) -> int:
    n = 1
    names = tuple(mesh.mesh_dim_names)
    for a in ("pod", "data"):
        if a in names:
            n *= mesh.shape[names.index(a)]
    return n
