"""The port's logical-axis sharding (`repro_torch.models.sharding`, the
spec trees of `repro_torch.models.model.Model`) against the reference,
at the published sizes and with nothing allocated:

- `rules_for(...).table` equal to the reference's for every architecture
  on the meshes (1, 1), (2, 4), (4, 2), (16, 16) and (2, 16, 16), at each
  cell's batch size and without one, with and without FSDP. Both read
  only a mesh's axis names and sizes, so they get stand-ins of the two
  kinds; one test builds real `DeviceMesh`es over a fake process group
  in a subprocess (a process group is process-wide) and gets the same
  tables;
- `param_specs`, `cache_specs` (each cell) and `batch_specs` equal to the
  reference's `PartitionSpec`s leaf for leaf (the trees have the same
  paths);
- placements: a nested ("pod", "data") axis splits rows pod-major, as JAX
  orders a tuple axis; a mesh dim of one rank replicates; out-of-order
  axes are refused;
- without rules every annotation is the identity: one reduced config per
  family gives bitwise the same loss and gradients with the sharding
  helpers replaced by their plain forms.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import model as RM
from repro.models.sharding import rules_for as ref_rules_for
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R
from repro_torch.models import sharding as S
from repro_torch.models import transformer as T
from repro_torch.models.config import SHAPE_CELLS
from repro_torch.models.model import Model

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(1, 1), (2, 4), (4, 2), (16, 16), (2, 16, 16)]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _names(shape):
    return ("pod", "data", "model")[-len(shape):]


class RefMesh:
    """What the reference's rules_for reads of a jax Mesh."""

    def __init__(self, shape):
        self.axis_names = _names(shape)
        self.shape = dict(zip(self.axis_names, shape))


class PortMesh:
    """What the port's rules_for reads of a DeviceMesh."""

    def __init__(self, shape):
        self.mesh_dim_names = _names(shape)
        self.shape = tuple(shape)


def _tables(arch, shape):
    out = []
    for bs in [None] + sorted({c.global_batch for c in SHAPE_CELLS}):
        for fsdp in (True, False):
            ref = ref_rules_for(ref_get_config(arch), RefMesh(shape),
                                batch_size=bs, fsdp=fsdp).table
            got = S.rules_for(get_config(arch), PortMesh(shape),
                              batch_size=bs, fsdp=fsdp).table
            out.append((bs, fsdp, ref, got))
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_tables_are_the_references(arch, shape):
    for bs, fsdp, ref, got in _tables(arch, shape):
        assert got == ref, (arch, shape, bs, fsdp)


_REAL_MESHES = r"""
import json, sys, torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.sharding import rules_for
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
out = {}
for shape in json.loads(sys.argv[1]):
    names = ("pod", "data", "model")[-len(shape):]
    n = 1
    for s in shape:
        n *= s
    mesh = DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=names)
    for arch in ARCH_IDS:
        for bs in (None, 1, 256):
            t = rules_for(get_config(arch), mesh, batch_size=bs).table
            out[f"{arch}|{shape}|{bs}"] = {k: list(v) if isinstance(v, tuple)
                                           else v for k, v in t.items()}
print("TABLES " + json.dumps(out))
"""


def _run(code, *args, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    out = subprocess.run([sys.executable, "-c", code, *args], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_rules_on_real_device_meshes_are_the_references():
    import json
    got = json.loads([x for x in _run(_REAL_MESHES, json.dumps(SHAPES))
                      .splitlines() if x.startswith("TABLES ")][0][7:])
    for shape in SHAPES:
        for arch in ARCH_IDS:
            for bs in (None, 1, 256):
                ref = ref_rules_for(ref_get_config(arch), RefMesh(shape),
                                    batch_size=bs).table
                want = {k: list(v) if isinstance(v, tuple) else v
                        for k, v in ref.items()}
                assert got[f"{arch}|{list(shape)}|{bs}"] == want, \
                    (arch, shape, bs)


def _flat(tree, prefix=()):
    """path -> leaf of a spec tree (dicts and lists; specs are tuples)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (str(k),)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, prefix + (str(i),)))
        return out
    return {"/".join(prefix): tuple(tree)}


def _ref_flat(tree):
    from jax.sharding import PartitionSpec as P
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): tuple(leaf) for path, leaf in leaves}


_REF_ABSTRACT = {}


def _ref_abstract(arch):
    if arch not in _REF_ABSTRACT:
        _REF_ABSTRACT[arch] = RM.Model(ref_get_config(arch)).abstract_params()
    return _REF_ABSTRACT[arch]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_are_the_references(arch):
    abstract = _ref_abstract(arch)
    model = Model(get_config(arch))
    for shape in SHAPES:
        for fsdp in (True, False):
            ref_ax = ref_rules_for(ref_get_config(arch), RefMesh(shape),
                                   batch_size=256, fsdp=fsdp)
            ax = S.rules_for(get_config(arch), PortMesh(shape),
                             batch_size=256, fsdp=fsdp)
            want = _ref_flat(RM._spec_tree(
                abstract, RM._PARAM_RULES, ref_ax,
                stacked_prefixes=("segments", "enc_segments")))
            got = _flat(model.param_specs(ax))
            assert got == want, (arch, shape, fsdp)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_specs_are_the_references(arch):
    ref_model = RM.Model(ref_get_config(arch))
    model = Model(get_config(arch))
    for shape in SHAPES:
        for cell in SHAPE_CELLS:
            ref_ax = ref_rules_for(ref_get_config(arch), RefMesh(shape),
                                   batch_size=cell.global_batch)
            ax = S.rules_for(get_config(arch), PortMesh(shape),
                             batch_size=cell.global_batch)
            want = _ref_flat(ref_model.cache_specs(
                ref_ax, cell.global_batch, cell.seq_len))
            got = _flat(model.cache_specs(ax, cell.global_batch,
                                          cell.seq_len))
            assert got == want, (arch, shape, cell.name)
            want = {k: tuple(v) for k, v in
                    ref_model.batch_specs(ref_ax, cell).items()}
            assert model.batch_specs(ax, cell) == want, (arch, cell.name)
            ref_in = ref_model.input_specs(cell)
            got_in = model.input_specs(cell)
            assert sorted(got_in) == sorted(ref_in)
            for k, v in got_in.items():
                assert tuple(v.shape) == tuple(ref_in[k].shape)
                assert v.device.type == "meta"


def test_abstract_cache_is_the_references_on_meta():
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        got = Model(cfg).abstract_cache(4, 64)
        ref = RM.Model(ref_get_config(arch)).abstract_cache(4, 64)
        ref_flat = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                             for p in path): tuple(leaf.shape)
                    for path, leaf in
                    jax.tree_util.tree_flatten_with_path(ref)[0]}
        got_flat = {}
        for path, leaf in _flat_tensors(got):
            got_flat[path] = tuple(leaf.shape) if isinstance(
                leaf, torch.Tensor) else ()
            if isinstance(leaf, torch.Tensor):
                assert leaf.device.type == "meta"
        assert got_flat == ref_flat, arch


def _flat_tensors(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_tensors(v, prefix + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat_tensors(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


_PLACEMENTS = r"""
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.models.sharding import local_range, placements_for
for rank in range(8):
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=8)
    mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 2, 2),
                      mesh_dim_names=("pod", "data", "model"))
    pl = placements_for(mesh, (("pod", "data"), None, "model"))
    assert pl == (Shard(0), Shard(0), Shard(2)), pl
    x = distribute_tensor(torch.zeros(16, 3, 4), mesh, list(pl),
                          src_data_rank=None)
    p, d, m = rank // 4, (rank // 2) % 2, rank % 2
    # JAX: a tuple axis orders the devices of its mesh axes pod-major
    assert local_range(x, 0) == ((p * 2 + d) * 4, 4), (rank, local_range(x, 0))
    assert local_range(x, 2) == (m * 2, 2)
    one = DeviceMesh("cpu", torch.arange(8).reshape(8, 1),
                     mesh_dim_names=("data", "model"))
    assert placements_for(one, (None, "model")) == (Replicate(), Replicate())
    assert placements_for(one, ("data", None)) == (Shard(0), Replicate())
    for bad in ((("data", "pod"),), ("model", "model")):
        try:
            placements_for(mesh, bad)
        except ValueError:
            pass
        else:
            raise AssertionError(bad)
    dist.destroy_process_group()
print("PLACEMENTS_OK")
"""


def test_placements_follow_the_mesh_order():
    assert "PLACEMENTS_OK" in _run(_PLACEMENTS)


def _plain_helpers(monkeypatch):
    """Every sharding helper the model calls, replaced by its plain form."""
    ident = lambda x, *axes: x
    for mod in (L, R, T):
        if hasattr(mod, "shard"):
            monkeypatch.setattr(mod, "shard", ident)
    monkeypatch.setattr(L, "on_replicas", lambda fn, *a: fn(*a))
    monkeypatch.setattr(T, "on_replicas", lambda fn, *a: fn(*a))
    monkeypatch.setattr(L, "per_head_shard", lambda fn, *a: fn(*a))
    monkeypatch.setattr(R, "per_shard", lambda fn, roles, out, *a: fn(*a))
    monkeypatch.setattr(L, "split_dim", lambda x, dim, sizes: x.reshape(
        *x.shape[:dim], *sizes, *x.shape[dim + 1:]))
    monkeypatch.setattr(T, "take_rows", lambda table, i: table[i])
    monkeypatch.setattr(L, "is_sharded", lambda x, d: False)
    monkeypatch.setattr(T, "is_sharded", lambda x, d: False)

    def write(cache, slot, value):
        cache[:, slot] = value

    monkeypatch.setattr(L, "write_slot", write)
    monkeypatch.setattr(T, "pick_last", lambda x, i: torch.gather(
        x, -1, i[..., None])[..., 0])


def _loss_and_grads(cfg):
    params = T.init_params(3, cfg, "cpu")
    leaves = [p.requires_grad_() for p in T.leaves(params)]
    g = torch.Generator().manual_seed(4)
    tok = torch.randint(0, cfg.vocab, (2, 16), generator=g)
    batch = {"tokens": tok, "labels": tok.roll(-1, 1)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(2, cfg.enc_seq, cfg.d_model,
                                      generator=g)
    loss = T.lm_loss(params, batch, cfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    with torch.no_grad():
        cache = T.init_cache(cfg, 2, 8, "cpu")
        if cfg.family == "encdec":
            T.fill_cross_kv(params, cache, T.encode(params, batch["frames"],
                                                    cfg), cfg)
        logits, _ = T.decode_step(params, cache, tok[:, :1], cfg)
    return loss.detach(), grads, logits


@pytest.mark.parametrize("arch", ["gemma-2b", "moonshot-v1-16b-a3b",
                                  "recurrentgemma-9b", "rwkv6-7b",
                                  "whisper-medium"])
def test_annotations_are_the_identity_without_rules(arch, monkeypatch):
    cfg = reduced(get_config(arch))
    with S.axis_rules(None):
        got = _loss_and_grads(cfg)
    x = torch.ones(3, 4)
    assert S.shard(x, "batch", None) is x
    _plain_helpers(monkeypatch)
    want = _loss_and_grads(cfg)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert (a is None and b is None) or torch.equal(a, b)
    assert torch.equal(got[2], want[2])
