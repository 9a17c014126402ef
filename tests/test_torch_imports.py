"""The port imports neither JAX (nor `ml_dtypes`, JAX's bf16 type) nor
the reference package, also while it serves through `MicroBatcher` on
the elastic and cached backends, spills and restores at every spec
(`repro_torch.index.persist`), rebuilds in its maintenance loop and
audits served queries (`repro_torch.obs.audit`), queries a sharded
engine (directly and through `pruned:sharded`), runs the ring exact ranks
and a QSRP query, prefills and decodes every architecture of the LM
substrate (`repro_torch.models`, `repro_torch.configs`) and runs step 4
of `serve_retrieval`, trains a tiny MoE (`repro_torch.launch.train.
run_training`), checkpoints it and resumes it bitwise; its serving driver (`python -m
repro_torch.launch.serve`) and the examples run under the same blocker
(`chip_smoke.run_blocked`), as do a 1 x 1 sharded training run on a
single-rank gloo group (bitwise the unsharded run) and the dry run
(`python -m repro_torch.launch.dryrun`); and its entry points never fall
back to the CPU quietly."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"

# Runs in a fresh interpreter: blocking modules by import hooks in the
# pytest process would break every JAX test that shares the worker.
_NO_JAX = r"""
import importlib, importlib.abc, pkgutil, sys, time

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import torch
from repro_torch.core.engine import ReverseKRanksEngine
from repro_torch.core.types import RankTableConfig
from repro_torch.data.pipeline import synthetic_embeddings
users, items = synthetic_embeddings(0, 64, 40, 8, device="cpu")
eng = ReverseKRanksEngine.build(users, items, RankTableConfig(tau=8,
                                omega=2, s=4), 0, backend="fused",
                                device="cpu")
res = eng.query(items[3], 5, 2.0)
assert res.indices.shape == (5,)
for spec in ("bf16", "int8"):
    eng = ReverseKRanksEngine.build(users, items, RankTableConfig(
        tau=8, omega=2, s=4, storage_dtype=spec), 0, backend="fused",
        device="cpu")
    assert eng.rank_table.spec_kind == spec
    assert eng.query(items[3], 5, 2.0).indices.shape == (5,)
from repro_torch.core.backends import PrunedBackend
from repro_torch.data.pipeline import mid_mixture
users, items, _ = mid_mixture(0, 1024, 40, 8, device="cpu")
for inner in ("dense", "fused"):
    eng = ReverseKRanksEngine.build(users, items, RankTableConfig(
        tau=8, omega=2, s=4), 0, backend=PrunedBackend(inner, block_size=32),
        device="cpu", cluster_reorder=True)
    assert eng.user_remap is not None
    assert eng.query_batch(items[:3], 5, 2.0).indices.shape == (3, 5)
from repro_torch.serve import MicroBatcher
users, items = synthetic_embeddings(0, 64, 40, 8, device="cpu")
for backend in ("elastic:fused", "cached:elastic:dense"):
    eng = ReverseKRanksEngine.build(users, items, RankTableConfig(tau=8,
                                    omega=2, s=4), 0, backend=backend,
                                    device="cpu")
    mb = MicroBatcher(eng, max_batch=4, max_wait_ms=1.0)
    try:
        futs = [mb.submit(items[i].numpy(), 5, 2.0) for i in range(6)]
        want = eng.query_batch(items[:6], 5, 2.0)
        for i, f in enumerate(futs):
            assert torch.equal(f.result(timeout=60).indices, want.indices[i])
    finally:
        mb.close()
import tempfile
from repro_torch.index import IndexPersister, MaintenanceLoop, \
    MaintenancePolicy
from repro_torch.obs import QualityAuditor
users, items = synthetic_embeddings(0, 64, 48, 8, device="cpu")
for spec in ("f32", "bf16", "int8"):
    eng = ReverseKRanksEngine.build(users, items[:40], RankTableConfig(
        tau=8, omega=2, s=4, storage_dtype=spec), 0, backend="fused",
        device="cpu")
    with tempfile.TemporaryDirectory() as d:
        eng.attach_persister(IndexPersister(d))
        ml = MaintenanceLoop(eng, policy=MaintenancePolicy(
            max_delta_ratio=0.1), poll_ms=5.0)
        try:
            eng.insert_items(items[40:])
            eng.delete_users([1])
            for _ in range(6000):
                if ml.rebuilds:
                    break
                ml.wake()
                time.sleep(0.01)
        finally:
            ml.close()
        assert ml.rebuilds, "the maintenance loop never rebuilt"
        got = ReverseKRanksEngine.restore(d, backend="fused", device="cpu")
        assert got.epoch == eng.epoch
        assert torch.equal(got.rank_table.table, eng.rank_table.table)
    aud = QualityAuditor(eng, fraction=1.0)
    mb = MicroBatcher(eng, max_batch=4, max_wait_ms=1.0, auditor=aud)
    try:
        for f in [mb.submit(items[i].numpy(), 5, 2.0) for i in range(4)]:
            f.result(timeout=60)
        mb.flush()
        assert aud.flush(timeout=60) and aud.scored >= 4
    finally:
        mb.close()
        aud.close()
from repro_torch.core import distributed as D
from repro_torch.core.qsrp import build_qsrp_index, qsrp_query
users, items, _ = mid_mixture(0, 1024, 40, 8, device="cpu")
mesh = ("cpu",) * 2
eng = ReverseKRanksEngine.build(users, items, RankTableConfig(tau=8,
                                omega=2, s=4), 0, backend="sharded",
                                device="cpu", mesh=mesh)
assert eng._backend.build_fallback == "" and eng.mesh == mesh
res = eng.query_batch(items[:3], 5, 2.0)
assert res.indices.shape == (3, 5) and res.r_lo.shape == (3, 10)
eng = ReverseKRanksEngine(eng.users, eng.rank_table, eng.config,
                          backend=PrunedBackend("sharded", mesh=mesh,
                                                block_size=32,
                                                max_union_frac=1.0))
assert torch.equal(eng.query_batch(items[:3], 5, 2.0).indices, res.indices)
assert eng._backend.stats.fallback == ""
ring = D.ring_exact_ranks(users, items, items[3], mesh)
assert ring.shape == (1024,) and ring.dtype == torch.float32
idx = build_qsrp_index(users, items, levels=8)
got, ranks, _ = qsrp_query(idx, users, items, items[3], 5, 2.0)
assert got.shape == (5,) and ranks.shape == (5,)
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.models import transformer as T
from repro_torch.models.model import Model
for arch in ARCH_IDS:
    cfg = reduced(get_config(arch))
    model = Model(cfg)
    params = model.init_params(0, device="cpu")
    toks = torch.randint(cfg.vocab, (1, 4))
    frames = (torch.randn(1, cfg.enc_seq, cfg.d_model)
              if cfg.family == "encdec" else None)
    assert model.forward_logits(params, toks, frames).shape == (1, 4,
                                                                cfg.vocab)
    cache = model.init_cache(1, 6, device="cpu")
    if frames is not None:
        cache = T.fill_cross_kv(params, cache, T.encode(params, frames, cfg),
                                cfg)
    lg, cache = model.decode_step(params, cache, toks[:, :1])
    assert lg.shape == (1, 1, cfg.vocab) and cache["len"] == 1
import contextlib, io
from repro_torch.examples import serve_retrieval
with contextlib.redirect_stdout(io.StringIO()):     # its answer line
    out = serve_retrieval.backbone_step(torch.device("cpu"), n_users=32,
                                        n_items=16)
assert len(out["result"].indices) == 5
import dataclasses, tempfile
from repro_torch.launch.train import run_training
from repro_torch.train import checkpoint as ckpt
cfg = dataclasses.replace(reduced(get_config("moonshot-v1-16b-a3b")),
                          d_model=32, d_ff=64, vocab=128, remat="dots")
kw = dict(global_batch=2, seq_len=8, lr=1e-3, device="cpu")
with tempfile.TemporaryDirectory() as d, \
        contextlib.redirect_stdout(io.StringIO()):
    p_full, l_full = run_training(cfg, steps=4, **kw)
    run_training(cfg, steps=2, ckpt_dir=d, **kw)
    p_res, l_res = run_training(cfg, steps=4, ckpt_dir=d, **kw)
    assert ckpt.latest_step(d) == 4
    tpl = {"params": Model(cfg).abstract_params()}
    back, _, _ = ckpt.restore(d, {"params": tpl["params"]}, device="cpu")
assert l_res == l_full[2:]
for a, b, c in zip(T.leaves(p_full), T.leaves(p_res),
                   T.leaves(back["params"])):
    assert torch.equal(a, b) and torch.equal(b, c)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"))
assert not bad, bad
print("OK", len(names))
"""


def test_port_imports_and_runs_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", _NO_JAX], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")
    assert int(out.stdout.split()[1]) >= 15      # every submodule imported


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(SRC)))
def test_no_file_of_the_port_imports_jax_or_reference(path):
    roots = {name.split(".")[0] for name in _imports(path)}
    assert not roots & {"jax", "jaxlib", "ml_dtypes", "repro"}, roots


def test_entry_points_without_device_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch.core.engine import ReverseKRanksEngine
    from repro_torch.core.types import RankTableConfig
    from repro_torch.data.pipeline import synthetic_embeddings
    x = torch.zeros(4, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReverseKRanksEngine.build(x, x, RankTableConfig(tau=2, omega=1,
                                                        s=1), 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthetic_embeddings(0, 4, 4, 2)


def test_f32_products_stay_ieee():
    import repro_torch  # noqa: F401  (the import sets the switches)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"


_SMALL = ("--n", "1024", "--m", "400", "--d", "16", "--tau", "16",
          "--queries", "16", "--max-batch", "4", "--device", "cpu")


@pytest.mark.parametrize("args", [
    ("repro_torch.launch.serve", *_SMALL, "--backend", "elastic:fused",
     "--storage", "bf16", "--audit-fraction", "0.5"),
    ("repro_torch.launch.serve", *_SMALL, "--backend", "cached:pruned:fused",
     "--mf", "--n-ratings", "9000", "--mf-epochs", "1"),
    ("-c", "from repro_torch.examples import quickstart\n"
           "quickstart.main(device='cpu', n_users=500, n_items=200, dim=16)"),
    ("-c", "from repro_torch.examples import ablation\n"
           "ablation.main(device='cpu', n=500, m=200, d=16, n_eval=2)"),
    ("-c", "from repro_torch.examples import serve_retrieval\n"
           "serve_retrieval.main(device='cpu', n_users=300, n_items=120, "
           "n_ratings=9000)"),
], ids=["serve-elastic-bf16-audit", "serve-cached-pruned-mf", "quickstart",
        "ablation", "serve_retrieval"])
def test_cli_and_examples_run_without_jax_or_reference(args):
    import chip_smoke
    out = chip_smoke.run_blocked(*args, timeout=180)
    assert out.returncode == 0, out.stderr[-4000:]
    assert chip_smoke.runner_report(out.stdout)["leaked"] == []
    assert "acc" in out.stdout          # each prints its §5 grades


@pytest.mark.parametrize("module", ["repro_torch.examples.quickstart",
                                    "repro_torch.examples.ablation",
                                    "repro_torch.examples.serve_retrieval"])
def test_examples_without_device_need_a_card(module):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    import chip_smoke
    out = chip_smoke.run_blocked(module, timeout=180)
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr


_SHARDED = r"""
import socket
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config, reduced
from repro_torch.launch import mesh, roofline, roofline_report  # noqa: F401
from repro_torch.launch.train import run_training
from repro_torch.models.transformer import leaves
with socket.socket() as s:
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=0, world_size=1)
m = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
cfg = reduced(get_config("granite-3-8b"))
kw = dict(steps=2, global_batch=2, seq_len=16, log_every=10**6,
          device="cpu")
pa, la = run_training(cfg, mesh=m, **kw)
pb, lb = run_training(cfg, **kw)
assert la == lb, (la, lb)
assert all(torch.equal(a.to_local(), b) for a, b in zip(leaves(pa),
                                                       leaves(pb)))
dist.destroy_process_group()
print("SHARDED_OK")
"""


@pytest.mark.parametrize("args", [
    ("-c", _SHARDED),
    ("repro_torch.launch.dryrun", "--arch", "gemma-2b", "--shape",
     "decode_32k"),
], ids=["sharded-train-1x1", "dryrun-decode"])
def test_sharding_and_launchers_run_without_jax_or_reference(args):
    import chip_smoke
    out = chip_smoke.run_blocked(*args, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    rep = chip_smoke.runner_report(out.stdout)
    assert rep["leaked"] == []
    assert "SHARDED_OK" in out.stdout or "dry-run: 1 OK, 0 SKIP, 0 FAIL" \
        in out.stdout, out.stdout[-2000:]
