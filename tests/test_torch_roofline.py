"""The port's roofline and dry run (`repro_torch.launch.roofline`,
`launch.dryrun`, `launch.roofline_report`, `launch.mesh`) against the
reference's, on the CPU:

- `shape_bytes` with torch dtype names; the three terms and the
  bottleneck on the reference's `test_analyze_terms_and_bottleneck`
  numbers, and with the H100's constants;
- `model_flops_train` / `model_flops_decode` equal to the reference's on
  every architecture's abstract parameters (the MoE discount and the
  embedding-table rule included);
- `rows_from` / `to_markdown` equal to `benchmarks/roofline_report.py`'s
  on the same records;
- a dry run in a subprocess (a fake process group is process-wide) of a
  reduced gemma config with 4 KV heads, so that every dim divides, on a
  fake (2, 4) mesh and on a (1, 1) one: per-device FLOPs times the chips
  equal the unsharded count; collectives counted on the 4-way model axis
  and none on (1, 1); the records' keys are the reference's; the
  decode, prefill and train cells all trace;
- `dryrun_engine` at a small scale on 8 shards: the reference's record
  keys, the query's collective steps, the ring's item blocks and FLOPs.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

from benchmarks import roofline_report as ref_report
from repro.configs import get_config as ref_get_config
from repro.launch import roofline as ref_RL
from repro.models.model import Model as RefModel
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import roofline as RL
from repro_torch.launch import roofline_report as report
from repro_torch.launch.mesh import H100_SXM, dp_size
from repro_torch.models.model import Model

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_shape_bytes():
    assert RL.shape_bytes("bfloat16", "16,2048") == 16 * 2048 * 2
    assert RL.shape_bytes("float32", "128") == 512
    assert RL.shape_bytes("bool", "8,8") == 64
    assert RL.shape_bytes("int64", "3") == 24
    assert RL.shape_bytes("float32", "") == 4          # scalar


def _counts(flops, hbm, coll):
    detail = {k: 0 for k in RL._COLLECTIVES}
    detail["all-gather"] = coll
    detail["total"] = coll
    detail["counts"] = {k: 0 for k in RL._COLLECTIVES}
    return RL.StepCounts(flops=flops, hbm_bytes=hbm, coll_detail=detail,
                         peak_bytes=0, out=None)


def test_terms_and_bottleneck_are_the_references():
    hw = {"peak_bf16_flops": 197e12, "hbm_bw": 819e9, "ib_bw": 50e9}
    r = RL.terms(_counts(197e12, 819e9 * 2, 400), chips=4,
                 model_flops=197e12 * 4, hw=hw)
    assert abs(r.compute_s - 1.0) < 1e-9
    assert abs(r.memory_s - 2.0) < 1e-9
    assert abs(r.collective_s - 400 / 50e9) < 1e-18
    assert r.bottleneck == "memory"
    assert abs(r.useful_ratio - 1.0) < 1e-9
    assert [f.name for f in dataclasses.fields(RL.Roofline)] == \
        [f.name for f in dataclasses.fields(ref_RL.Roofline)]
    r = RL.terms(_counts(989e12, 3.35e12, 100e9), chips=2)
    assert abs(r.compute_s - 1.0) < 1e-12 and abs(r.memory_s - 1.0) < 1e-12
    assert abs(r.collective_s - 2.0) < 1e-12 and r.bottleneck == "collective"
    assert r.useful_ratio is None
    assert H100_SXM["peak_bf16_flops"] == 989e12
    assert H100_SXM["hbm_bw"] == 3.35e12


class _Mesh:
    def __init__(self, names, shape):
        self.mesh_dim_names, self.shape = names, shape


def test_dp_size():
    assert dp_size(_Mesh(("data", "model"), (16, 16))) == 16
    assert dp_size(_Mesh(("pod", "data", "model"), (2, 16, 16))) == 32


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_are_the_references(arch):
    ref_ap = RefModel(ref_get_config(arch)).abstract_params()
    cfg = get_config(arch)
    ap = Model(cfg).abstract_params()
    assert RL.count_params(ap) == sum(int(x.size)
                                      for x in jax.tree.leaves(ref_ap))
    for tokens in (1000, 256 * 4096, 128):
        assert RL.model_flops_train(cfg, ap, tokens) == \
            ref_RL.model_flops_train(ref_get_config(arch), ref_ap, tokens)
        assert RL.model_flops_decode(cfg, ap, tokens) == \
            ref_RL.model_flops_decode(ref_get_config(arch), ref_ap, tokens)
    if cfg.n_experts:
        assert RL.model_flops_train(cfg, ap, 1000) < \
            6.0 * RL.count_params(ap) * 1000


def _records():
    roof = dict(flops=1e12, hbm_bytes=2e11, coll_bytes=3e9, compute_s=2.5,
                memory_s=0.0005, collective_s=7e-7, bottleneck="compute",
                model_flops=4e14, useful_ratio=0.83, coll_detail=None)
    return [
        {"arch": "gemma-2b", "cell": "train_4k", "mesh": "16x16",
         "status": "OK", "chips": 256, "arg_bytes": 3 * 2**30,
         "roofline": roof},
        {"arch": "gemma-2b", "cell": "decode_32k", "mesh": "16x16",
         "status": "OK", "chips": 256, "arg_bytes": 2**29,
         "roofline": dict(roof, useful_ratio=None, memory_s=3.0,
                          bottleneck="memory")},
        {"arch": "gemma-2b", "cell": "long_500k", "mesh": "2x16x16",
         "status": "SKIP", "reason": "full-attention arch"},
        {"arch": "qwen3-32b", "cell": "prefill_32k", "mesh": "2x16x16",
         "status": "FAIL", "error": "RuntimeError('x' * 99)"},
    ]


def test_report_is_the_references():
    recs = _records()
    assert report.rows_from(recs) == ref_report.rows_from(recs)
    assert report.to_markdown(report.rows_from(recs)) == \
        ref_report.to_markdown(ref_report.rows_from(recs))
    for x in (2.0, 0.5, 3e-5):
        assert report.fmt_s(x) == ref_report.fmt_s(x)


def test_report_main_prints_the_table(tmp_path, capsys):
    path = tmp_path / "recs.json"
    path.write_text(json.dumps(_records()))
    sys_argv = sys.argv
    try:
        sys.argv = ["roofline_report", str(path), "--md"]
        report.main()
    finally:
        sys.argv = sys_argv
    assert capsys.readouterr().out.strip() == report.to_markdown(
        report.rows_from(_records()))


_DRYRUN = r"""
import dataclasses, json, warnings, logging
warnings.filterwarnings("ignore")
logging.disable(logging.WARNING)
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.configs import get_config, reduced
from repro_torch.launch import dryrun as DR
from repro_torch.launch import roofline as RL
from repro_torch.models.model import Model
from repro_torch.models.transformer import tree_map
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.trainer import make_train_step

cfg = dataclasses.replace(reduced(get_config("gemma-2b")), n_kv_heads=4,
                          remat="none")
DR.start_fake_group(8)
out = {}
for shape in ((2, 4), (1, 1)):
    n = shape[0] * shape[1]
    mesh = DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=("data", "model"))
    for cell in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        out[f"{shape}|{cell}"] = DR.dryrun_cell("gemma-2b", cell,
                                                mesh=mesh, cfg=cfg,
                                                verbose=False)

# the unsharded count of the train cell: plain fake tensors, no rules
cell = DR.CELLS["train_4k"]
model = Model(cfg)
with FakeTensorMode():
    mk = lambda p: torch.empty(p.shape, dtype=p.dtype)
    params = tree_map(mk, model.abstract_params())
    batch = {k: mk(v) for k, v in model.input_specs(cell).items()}
    c = RL.measure(make_train_step(model, AdamWConfig()), params,
                   adamw_init(params), batch)
out["plain_flops"] = c.flops
print("DRYRUN " + json.dumps(out))
"""


def test_dry_run_of_a_reduced_config_on_fake_meshes():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    env["OMP_NUM_THREADS"] = "2"
    got = subprocess.run([sys.executable, "-c", _DRYRUN], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-4000:]
    out = json.loads([x for x in got.stdout.splitlines()
                      if x.startswith("DRYRUN ")][0][7:])
    # the reference's record keys (repro/launch/dryrun.py::dryrun_cell)
    ok_keys = {"arch", "cell", "mesh", "status", "chips", "lower_s",
               "compile_s", "bytes_per_device", "temp_bytes", "arg_bytes",
               "out_bytes", "roofline"}
    roof_keys = {f.name for f in dataclasses.fields(ref_RL.Roofline)}
    coll_keys = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                 "collective-permute", "total", "counts"}
    for shape in ("(2, 4)", "(1, 1)"):
        for cell in ("train_4k", "prefill_32k", "decode_32k"):
            rec = out[f"{shape}|{cell}"]
            assert rec["status"] == "OK", rec
            assert set(rec) == ok_keys
            assert set(rec["roofline"]) == roof_keys
            assert set(rec["roofline"]["coll_detail"]) == coll_keys
            assert rec["bytes_per_device"] == rec["temp_bytes"] + \
                rec["arg_bytes"] and rec["arg_bytes"] > 0
            total = rec["roofline"]["coll_detail"]["total"]
            if shape == "(1, 1)":
                assert total == 0, (cell, rec["roofline"]["coll_detail"])
            else:
                assert total > 0, cell
        skip = out[f"{shape}|long_500k"]
        assert skip["status"] == "SKIP" and set(skip) == {
            "arch", "cell", "mesh", "status", "reason"}
    sharded = out["(2, 4)|train_4k"]
    assert sharded["chips"] == 8 and sharded["mesh"] == "2x4"
    flops = sharded["roofline"]["flops"]
    assert abs(flops * 8 - out["plain_flops"]) <= 1e-9 * out["plain_flops"]
    assert out["(1, 1)|train_4k"]["roofline"]["flops"] == out["plain_flops"]


def test_engine_dry_run_at_a_small_scale():
    from repro_torch.configs.paper_engine import DatasetScale
    from repro_torch.launch import dryrun as DR
    ds = DatasetScale("tiny", 1000, 500, 16)
    recs = DR.dryrun_engine(shards=8, dataset=ds, verbose=False)
    assert [r["cell"] for r in recs] == ["build", "query", "refine_ring"]
    n, m, d = 1000, 504, 16                 # m padded to a multiple of 8
    # the reference's engine record keys (repro/launch/dryrun.py)
    keys = {"arch", "cell", "mesh", "status", "chips", "bytes_per_device",
            "temp_bytes", "arg_bytes", "roofline"}
    for r in recs:
        assert set(r) == keys and r["status"] == "OK"
        assert r["mesh"] == "flat8" and r["chips"] == 8
        assert r["arch"] == "engine/tiny"
        assert r["bytes_per_device"] == r["temp_bytes"] + r["arg_bytes"]
    build, query, ring = (r["roofline"] for r in recs)
    assert query["coll_detail"]["counts"]["all-gather"] == 2
    assert query["coll_detail"]["counts"]["collective-permute"] == 1
    assert ring["coll_detail"]["counts"]["collective-permute"] == 7
    assert ring["coll_detail"]["collective-permute"] == 7 * (m // 8) * d * 4
    assert ring["model_flops"] == 2.0 * n * m * d
    # K3's plain version: the (n/P, m/P) score products and u·q per pair
    assert abs(ring["flops"] * 8 - 2.0 * n * m * d) <= 2.0 * n * d * 8
    assert build["model_flops"] == 2.0 * n * 640 * d
    assert build["flops"] * 8 >= build["model_flops"]
