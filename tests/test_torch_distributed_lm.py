"""The LM substrate's sharded training (`launch.train.run_training(mesh=)`,
`train.trainer.make_train_step(rules=)`, `train.checkpoint` with
`shardings=`) on 4 gloo ranks on the CPU: the counterpart of the
reference's `tests/dist/train_dist.py` and `resume_dist.py`.

The reference forces 8 host devices and uses a 4×2 mesh; here each rank
is a process of its own, so 4 ranks (a 2×2 ("data", "model") mesh and a
1×4 one) keep the suite's time while still sharding both axes. The
reference's sharded drivers fail in the reference itself, so the port
holds its sharded run against its own unsharded run (held against the
reference by `test_torch_train.py`):

  GRADS     one f32 step of gemma-2b (reduced) on 2×2 and on 1×4 against
            the unsharded step (AdamW at lr = eps = 1): the loss, the gradient
            leaf by leaf (`full_tensor()`), the grad norm, both moments
            and every new parameter within TOL_F32 (below); with the bf16
            compute copy, the gradient within TOL_BF16;
  PARITY    6 steps of the launcher on 2×2 against the unsharded run
            within LOSS_RTOL, with bf16 and with f32 activations (with
            bf16 a row-parallel product rounds each shard's partial sum to
            bf16 before the all-reduce, as GSPMD's does), and within the
            reference's rtol = atol = 5e-2;
  SHARDED   at least one parameter leaf is sharded, every loss finite,
            the loss falls;
  ELASTIC   a checkpoint saved on 2×2 restores through `shardings=` onto
            1×4, every leaf equal to what was saved, and steps to a
            finite loss;
  RESUME    a run killed at step 4 and resumed on 2×2 reproduces the
            uninterrupted 8 steps bitwise, losses and every parameter;
  FAMILIES  GRADS at f32 for every architecture (reduced), on both
            meshes, one parametrized case each.

Tolerances, from the readings of these runs: a leaf's error is its
largest absolute difference over the larger of its own largest magnitude
and 1e-3 of the whole tree's (llama4's router, at one expert a token,
has a gradient that is zero but for rounding). At f32 compute the
sharded and unsharded steps differ only in the order of f32 sums: at
most 4.1e-6 (a second moment) outside RWKV, so TOL_F32 = 1e-5 for the
loss, the grad norm and every leaf of the gradient, the moments and the
new parameters. RWKV-6's gradient is far worse conditioned: scaling its
parameters by 1 + 1e-7 noise moves it by 5e-5, and its 2×2 step reads
5.6e-5 (gradient) and 1.1e-4 (second moment), so TOL_RWKV = 5e-4. A
wrong sharded backward moves a leaf by 1e-1 or more (one data shard's
embedding gradient lost: 0.28). The bf16 compute copy rounds each
gradient to bf16 (2^-8 relative) in an order that differs: 8.4e-3, so
TOL_BF16 = 2^-5. The loss streams: at most 1.4e-5 relative apart with
bf16 activations and 4.2e-6 with f32 over the 6 steps, so
LOSS_RTOL = 1e-4.

`python tests/test_torch_distributed_lm.py DIR` runs the 4 ranks (DIR
holds the checkpoints), `... --grads OUT.json` the families' steps; each
test runs one in a subprocess, and each rank's collectives time out
after 120 s.
"""
import dataclasses
import datetime
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced

ROOT = Path(__file__).resolve().parents[1]
WORLD, STEPS, GB, SEQ = 4, 6, 8, 32
KILL_AT, TOTAL = 4, 8
MESHES = ((2, 2), (1, 4))
TOL_F32, TOL_RWKV, TOL_BF16, LOSS_RTOL = 1e-5, 5e-4, 2.0 ** -5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfg(arch="gemma-2b", **kw):
    return dataclasses.replace(reduced(get_config(arch)), remat="none", **kw)


def _full(t):
    from repro_torch.models.sharding import is_dtensor
    return (t.full_tensor() if is_dtensor(t) else t).detach()


def _one_step(cfg, mesh, bf16=False):
    """One train step of `cfg` at the seeded parameters on the first batch
    (with seeded frames for an encoder-decoder), on `mesh` (None:
    unsharded), with AdamW at lr = 1 and eps = 1: the update is then a
    smooth function of the gradient and as large as the parameters, so the
    new parameters show its errors. (At eps = 1e-8 the first step is
    lr·g/|g|, which turns a gradient that is zero but for rounding into
    ±lr; at a small lr the parameters' own rounding hides the update.)
    Returns the loss, the gradient, the grad norm, the new parameters and
    both moments, all as full tensors."""
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.models.config import ShapeCell
    from repro_torch.models.model import Model
    from repro_torch.models.sharding import distribute, rules_for, sharded
    from repro_torch.models.transformer import leaves, tree_map
    from repro_torch.train import trainer
    from repro_torch.train.optimizer import AdamWConfig, adamw_init

    model = Model(cfg)
    g = torch.Generator()
    g.manual_seed(0)
    params = model.init_params(g, "cpu")
    batch = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=SEQ,
                                         global_batch=GB),
                          device="cpu").batch_at(0)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((GB, cfg.enc_seq, cfg.d_model),
                                      generator=g)
    rules = None
    if mesh is not None:
        rules = rules_for(cfg, mesh, batch_size=GB)
        params = tree_map(lambda p, s: distribute(p, mesh, s), params,
                          model.param_specs(rules))
        bspecs = model.batch_specs(rules, ShapeCell("t", "train", SEQ, GB))
        batch = {k: distribute(v, mesh, bspecs[k]) for k, v in batch.items()}
    opt = adamw_init(params)
    if mesh is not None:
        opt = opt._replace(step=distribute(opt.step, mesh, ()))
    with sharded(rules):
        _, grads = trainer._value_and_grad(model, params, batch, bf16)
    grads = [_full(x) for x in leaves(grads)]
    params, opt, m = trainer.make_train_step(
        model, AdamWConfig(lr=1.0, eps=1.0), rules,
        bf16_compute_params=bf16)(params, opt, batch)
    return {"loss": float(m["loss"]), "grad": grads,
            "grad_norm": float(m["grad_norm"]),
            "params": [_full(x) for x in leaves(params)],
            "mu": [_full(x) for x in leaves(opt.mu)],
            "nu": [_full(x) for x in leaves(opt.nu)]}


def _errors(got: dict, want: dict) -> dict:
    """The relative error of each of `_one_step`'s results (module doc)."""
    errs = {k: abs(got[k] - want[k]) / abs(want[k])
            for k in ("loss", "grad_norm")}
    for key in ("grad", "params", "mu", "nu"):
        whole = max(float(b.abs().max()) for b in want[key])
        errs[key] = max(float((a - b).abs().max()) / max(
            float(b.abs().max()), 1e-3 * whole)
            for a, b in zip(got[key], want[key]))
    return errs


def _start(rank: int, port: int) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))


def _meshes():
    from torch.distributed.device_mesh import init_device_mesh
    return [init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
            for shape in MESHES]


def _worker(rank: int, port: int, tmp: str) -> None:
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.launch.train import run_training
    from repro_torch.models.model import Model
    from repro_torch.models.sharding import distribute, is_dtensor, \
        placements_for, rules_for
    from repro_torch.models.transformer import leaves, tree_map
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import AdamWConfig, OptState, \
        adamw_init
    from repro_torch.train.trainer import make_train_step

    _start(rank, port)
    say = print if rank == 0 else (lambda *a: None)
    try:
        cfg = _cfg()
        kw = dict(global_batch=GB, seq_len=SEQ, ckpt_every=10**6, lr=1e-3,
                  log_every=10**6, device="cpu")
        mesh_a, mesh_b = _meshes()

        # GRADS: one step on 2×2 and on 1×4 against the unsharded one
        cfg32 = _cfg(dtype="float32")
        for bf16, meshes, tol in ((False, (mesh_a, mesh_b), TOL_F32),
                                  (True, (mesh_a,), TOL_BF16)):
            want = _one_step(cfg32, None, bf16)
            for mesh in meshes:
                errs = _errors(_one_step(cfg32, mesh, bf16), want)
                say(f"GRADS {tuple(mesh.shape)} bf16 compute {bf16}: {errs}")
                keys = errs if not bf16 else ("loss", "grad", "grad_norm")
                assert all(errs[k] <= tol for k in keys), (bf16, errs)
        say("GRADS_OK")

        # PARITY and SHARDED: the launcher's loss streams
        _, ref = run_training(cfg, steps=STEPS, **kw)
        params, got = run_training(cfg, steps=STEPS, mesh=mesh_a, **kw)
        _, ref32 = run_training(cfg32, steps=STEPS, **kw)
        _, got32 = run_training(cfg32, steps=STEPS, mesh=mesh_a, **kw)
        for a, b in ((got, ref), (got32, ref32)):
            np.testing.assert_allclose(a, b, rtol=5e-2, atol=5e-2)
            np.testing.assert_allclose(a, b, rtol=LOSS_RTOL, atol=0)
        rel = lambda a, b: float(np.max(np.abs(np.subtract(a, b))
                                        / np.abs(b)))
        say(f"PARITY_OK losses {got} against {ref} (largest relative "
            f"difference {rel(got, ref):.3g}); f32 {got32} against {ref32} "
            f"({rel(got32, ref32):.3g})")
        sharded = [p for p in leaves(params) if is_dtensor(p) and any(
            not isinstance(pl, Replicate) and mesh_a.size(i) > 1
            for i, pl in enumerate(p.placements))]
        assert sharded, "no parameter leaf is sharded"
        assert np.isfinite(got).all() and got[-1] < got[0], got
        say(f"SHARDED_OK sharded_leaves={len(sharded)}")

        # ELASTIC: 2×2 → 1×4
        d = os.path.join(tmp, "elastic")
        saved, _ = run_training(cfg, steps=2, mesh=mesh_a, ckpt_dir=d, **kw)
        model = Model(cfg)
        rules_b = rules_for(cfg, mesh_b, batch_size=GB)
        abstract = model.abstract_params()
        pshard = tree_map(lambda _, s: (mesh_b, placements_for(mesh_b, s)),
                          abstract, model.param_specs(rules_b))
        tpl = {"params": abstract, "opt": adamw_init(abstract)}
        state, step, _ = ckpt.restore(d, tpl, shardings={
            "params": pshard, "opt": OptState(
                mu=pshard, nu=pshard,
                step=(mesh_b, placements_for(mesh_b, ())))})
        assert step == 2, step
        for a, b in zip(leaves(state["params"]), leaves(saved)):
            assert a.device_mesh is mesh_b
            assert torch.equal(a.full_tensor(), b.full_tensor())
        batch = TokenPipeline(PipelineConfig(
            vocab=cfg.vocab, seq_len=SEQ, global_batch=GB),
            device="cpu").batch_at(step)
        bspec = rules_b.spec("batch", None)
        batch = {k: distribute(v, mesh_b, bspec) for k, v in batch.items()}
        _, _, m = make_train_step(model, AdamWConfig(lr=1e-3), rules_b)(
            state["params"], state["opt"], batch)
        assert np.isfinite(float(m["loss"])), m
        say(f"ELASTIC_OK loss {float(m['loss'])} on 1x4")

        # RESUME: killed at step 4 on 2×2, resumed, against 8 steps
        full_p, full = run_training(cfg, steps=TOTAL, mesh=mesh_a, **kw)
        d = os.path.join(tmp, "resume")
        _, part_a = run_training(cfg, steps=KILL_AT, mesh=mesh_a,
                                 ckpt_dir=d, **kw)
        res_p, part_b = run_training(cfg, steps=TOTAL, mesh=mesh_a,
                                     ckpt_dir=d, **kw)
        assert part_a == full[:KILL_AT] and part_b == full[KILL_AT:], \
            (part_a, part_b, full)
        for a, b in zip(leaves(full_p), leaves(res_p)):
            assert tuple(a.placements) == tuple(b.placements)
            assert torch.equal(a.to_local(), b.to_local())
        say("BITWISE_RESUME_OK")
        say("ALL_OK")
    finally:
        dist.destroy_process_group()


def _grads_worker(rank: int, port: int, out: str) -> None:
    """FAMILIES: every architecture's f32 step on both meshes against its
    unsharded step; rank 0 writes {arch: {mesh: errors}} to `out`."""
    import torch.distributed as dist
    _start(rank, port)
    try:
        meshes = _meshes()
        got = {}
        for arch in ARCH_IDS:
            cfg = _cfg(arch, dtype="float32")
            want = _one_step(cfg, None)
            got[arch] = {"x".join(map(str, m.shape)):
                         _errors(_one_step(cfg, m), want) for m in meshes}
        if rank == 0:
            with open(out, "w") as f:
                json.dump(got, f)
    finally:
        dist.destroy_process_group()


def _main(argv: list) -> None:
    import socket
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    if argv[0] == "--grads":
        mp.spawn(_grads_worker, args=(port, argv[1]), nprocs=WORLD,
                 join=True)
    else:
        mp.spawn(_worker, args=(port, argv[0]), nprocs=WORLD, join=True)


def _run(*args) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, __file__, *map(str, args)],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-6000:]
    return out


def test_sharded_training_on_four_ranks(tmp_path):
    out = _run(tmp_path)
    for mark in ("GRADS_OK", "PARITY_OK", "SHARDED_OK", "ELASTIC_OK",
                 "BITWISE_RESUME_OK", "ALL_OK"):
        assert mark in out.stdout, out.stdout[-3000:]


@pytest.fixture(scope="module")
def family_errors(tmp_path_factory):
    path = tmp_path_factory.mktemp("grads") / "errors.json"
    _run("--grads", path)
    return json.loads(path.read_text())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_sharded_step_matches_unsharded(family_errors, arch):
    tol = TOL_RWKV if get_config(arch).family == "rwkv" else TOL_F32
    for mesh, errs in family_errors[arch].items():
        assert all(e <= tol for e in errs.values()), (mesh, errs)


if __name__ == "__main__":
    _main(sys.argv[1:])
