"""Three-term roofline model of one step on a mesh, counted per device.

    compute    = FLOPs(per-device)            / peak bf16 FLOP/s per GPU
    memory     = bytes accessed(per-device)   / HBM bytes/s per GPU
    collective = collective bytes(per-device) / InfiniBand bytes/s per GPU

Counterpart of the reference's `launch/roofline.py`, which reads XLA's
cost analysis and parses the compiled HLO text for collectives. Here
nothing is compiled: `measure(step_fn, *args)` runs the step once on fake
tensors (the caller's `FakeTensorMode`, DTensor arguments on a mesh of a
fake process group) under a dispatch mode that sees the local op each
rank runs, and counts for rank 0:

  * FLOPs of the local ops (`torch.utils.flop_counter`'s formulas on the
    local shapes; a DTensor-level count would be the global one);
  * bytes accessed: the input plus output bytes of each local op that is
    not a view — an upper bound, since nothing is fused;
  * collective bytes: the result bytes of each functional collective
    DTensor issues (`CommDebugMode`'s operations), by kind. On a CPU-type
    mesh DTensor makes an all-to-all as an all-gather and a chunk, which
    counts the gathered bytes;
  * the peak bytes of local tensors the step allocates, alive at once
    (storages shared by views count once; the arguments are not counted).

The ops DTensor runs on global-shape fakes to propagate its shardings are
not the ranks' work and are skipped. The HLO text parser
(`collective_bytes` of the reference) has no counterpart: there is no HLO.
"""
from __future__ import annotations

import dataclasses
import sys
import weakref
from typing import Optional

import torch

from repro_torch.launch.mesh import H100_SXM

_DTYPE_BYTES = {
    "bool": 1, "int8": 1, "uint8": 1, "float8_e4m3fn": 1, "float8_e5m2": 1,
    "int16": 2, "bfloat16": 2, "float16": 2, "int32": 4, "float32": 4,
    "int64": 8, "float64": 8, "complex64": 8,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# functional collective op name -> kind
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "permute_tensor": "collective-permute",
}


def shape_bytes(dtype: str, dims: str) -> int:
    """Bytes of a `dtype` (torch name: "bfloat16", "float32", ...) array
    of comma-separated `dims`."""
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class Roofline:
    flops: float                 # per-device FLOPs
    hbm_bytes: float             # per-device bytes accessed
    coll_bytes: float            # per-device collective bytes
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: Optional[float] = None   # 6·N·D (global)
    useful_ratio: Optional[float] = None  # MODEL / (FLOPs · chips)
    coll_detail: Optional[dict] = None

    def as_dict(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass
class StepCounts:
    """What `measure` counted for one rank."""
    flops: float
    hbm_bytes: float
    coll_detail: dict
    peak_bytes: int
    out: object                  # what the step returned


def _in_propagation() -> bool:
    """True inside DTensor's sharding propagation, which runs ops on
    global-shape fakes to learn output shapes."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _counter(arg_storages: set):
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import flop_registry

    class Counter(CommDebugMode):
        """CommDebugMode lets DTensor run each op and sees the local ops
        and collectives it issues; this one also counts them."""

        def __init__(self):
            super().__init__()
            self.flops = 0.0
            self.hbm = 0.0
            self.coll = {k: 0 for k in _COLLECTIVES}
            self.coll_counts = {k: 0 for k in _COLLECTIVES}
            self.live = 0
            self.peak = 0
            self._refs = {}

        def _release(self, key: int, nbytes: int) -> None:
            self._refs[key] -= 1
            if self._refs[key] == 0:
                del self._refs[key]
                self.live -= nbytes

        def _track(self, t: torch.Tensor) -> None:
            key = _storage_key(t)
            if key in arg_storages:
                return
            nbytes = t.untyped_storage().nbytes()
            if key not in self._refs:
                self._refs[key] = 0
                self.live += nbytes
                self.peak = max(self.peak, self.live)
            self._refs[key] += 1
            weakref.finalize(t, self._release, key, nbytes)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is NotImplemented or not isinstance(
                    func, torch._ops.OpOverload) or _in_propagation():
                return out
            outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
            for t in outs:
                self._track(t)
            name = func._overloadpacket.__name__
            if func.namespace in ("_c10d_functional", "c10d_functional"):
                kind = _KINDS.get(name)
                if kind is not None:
                    self.coll[kind] += sum(_nbytes(t) for t in outs)
                    self.coll_counts[kind] += 1
                return out
            if func.namespace == "prim" or func.is_view:
                return out
            packet = func._overloadpacket
            if packet in flop_registry:
                self.flops += float(flop_registry[packet](
                    *args, **(kwargs or {}), out_val=out))
            ins = [t for t in tree_leaves((args, kwargs or {}))
                   if isinstance(t, torch.Tensor)]
            self.hbm += sum(_nbytes(t) for t in ins + outs)
            return out

    return Counter()


def local_tensors(tree):
    """This rank's tensor of every tensor leaf of `tree` (dicts, lists,
    tuples; a DTensor's local shard)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from local_tensors(v)
    elif isinstance(tree, DTensor):
        yield tree.to_local()
    elif isinstance(tree, torch.Tensor):
        yield tree


def measure(step_fn, *args) -> StepCounts:
    """Run step_fn(*args) once and count it for this rank (module doc).
    Call it inside the `FakeTensorMode` that made the arguments."""
    arg_storages = {_storage_key(t) for t in local_tensors(args)}
    counter = _counter(arg_storages)
    with counter:
        out = step_fn(*args)
    detail = dict(counter.coll)
    detail["total"] = sum(counter.coll[k] for k in _COLLECTIVES)
    detail["counts"] = dict(counter.coll_counts)
    return StepCounts(flops=counter.flops, hbm_bytes=counter.hbm,
                      coll_detail=detail, peak_bytes=counter.peak, out=out)


def terms(counts: StepCounts, *, chips: int,
          model_flops: Optional[float] = None, hw: dict = H100_SXM
          ) -> Roofline:
    """The three terms and the bottleneck of `counts`, with the
    reference's formulas."""
    flops, hbm = counts.flops, counts.hbm_bytes
    coll = counts.coll_detail
    t_c = flops / hw["peak_bf16_flops"]
    t_m = hbm / hw["hbm_bw"]
    t_x = coll["total"] / hw["ib_bw"]
    bottleneck = max((("compute", t_c), ("memory", t_m),
                      ("collective", t_x)), key=lambda kv: kv[1])[0]
    useful = (model_flops / (flops * chips)
              if model_flops and flops else None)
    return Roofline(flops=flops, hbm_bytes=hbm, coll_bytes=coll["total"],
                    compute_s=t_c, memory_s=t_m, collective_s=t_x,
                    bottleneck=bottleneck, model_flops=model_flops,
                    useful_ratio=useful, coll_detail=coll)


def analyze(step_fn, *args, chips: int, model_flops: Optional[float] = None,
            hw: dict = H100_SXM) -> Roofline:
    """Run step_fn(*args) once on fake tensors and return its per-device
    roofline (`measure`, then `terms`)."""
    return terms(measure(step_fn, *args), chips=chips,
                 model_flops=model_flops, hw=hw)


def _named_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def count_params(tree) -> int:
    return sum(int(leaf.numel()) for _, leaf in _named_leaves(tree))


def model_flops_train(cfg, abstract_params, tokens: int) -> float:
    """6·N·D with MoE activation discounting (6·N_active·D)."""
    total = active = 0
    for keys, leaf in _named_leaves(abstract_params):
        n = int(leaf.numel())
        total += n
        if "moe/w_" in keys and cfg.n_experts:
            active += n * cfg.experts_per_tok / cfg.n_experts
        elif "embed/tok" in keys or "lm_head" in keys:
            # embedding gather is not a matmul; the LM head is — count the
            # head, skip the table (standard 6ND convention)
            active += n if "lm_head" in keys else 0
        else:
            active += n
    return 6.0 * active * tokens


def model_flops_decode(cfg, abstract_params, tokens: int) -> float:
    """2·N_active per generated token (forward only)."""
    return model_flops_train(cfg, abstract_params, tokens) / 3.0
