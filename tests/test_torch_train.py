"""The port's training path on the CPU: the train step
(`repro_torch.train.trainer`), the token pipeline
(`repro_torch.data.pipeline.TokenPipeline`), the launcher
(`repro_torch.launch.train`) and `examples/train_lm`.

- `make_train_step` against the reference's jitted step at f32 (compute
  params f32, the launcher's warmup-cosine schedule), microbatches 1 and
  2, three steps on the reference's batches from converted parameters:
  losses and grad norms within rtol 1e-5;
- microbatch accumulation against the full batch (the reference's
  criterion: loss within 2e-2, gradients within 5 % relative L1), and
  the step at microbatches 2 equal to the step on the accumulated
  gradients; bf16 against f32 compute params within 0.05;
- the pipeline: deterministic, step-dependent, host slices of B/H rows
  that differ, labels the tokens shifted by one, tokens < V; its Zipf
  marginal and repeat share against the reference's draws at the same
  config, within six standard deviations of their sampling error;
- the launcher: its flags are the reference's (same defaults) plus
  --device and --log-every; a tiny run killed at step 3 and resumed is
  bitwise the uninterrupted run; `python -m repro_torch.launch.train
  --device cpu` runs and resumes in a subprocess under the import
  blocker; no --device and no card raises; `examples/train_lm --tiny`
  drops the loss by more than 0.3.

Two tests marked `cuda` skip here: the pipeline's stream is the same on
the CPU and the card, and a train step on the card is bitwise repeatable.
"""
import ast
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data.pipeline import PipelineConfig as RefPipelineConfig
from repro.data.pipeline import TokenPipeline as RefTokenPipeline
from repro.models.model import Model as RefModel
from repro.train.optimizer import AdamWConfig as RefAdamWConfig
from repro.train.optimizer import adamw_init as ref_adamw_init
from repro.train.optimizer import cosine_schedule as ref_cosine
from repro.train.trainer import make_train_step as ref_make_train_step
from repro_torch import configs, convert
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.launch import train as launch
from repro_torch.models import transformer as T
from repro_torch.models.model import Model
from repro_torch.train.optimizer import AdamWConfig, OptState, \
    adamw_init, adamw_update, cosine_schedule
from repro_torch.train.trainer import _value_and_grad, init_train_state, \
    make_train_step

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _clone_state(params, opt):
    return (T.tree_map(torch.clone, params),
            OptState(T.tree_map(torch.clone, opt.mu),
                     T.tree_map(torch.clone, opt.nu), opt.step.clone()))


# ------------------------------------------------------- the train step
STEPS, GB, SEQ = 3, 4, 8


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["granite-3-8b", "moonshot-v1-16b-a3b",
                                  "rwkv6-7b"])
def test_train_step_matches_reference_f32(arch, microbatches):
    changes = dict(dtype="float32", remat="none")
    ref_cfg = dataclasses.replace(
        ref_configs.reduced(ref_configs.get_config(arch)), **changes)
    cfg = dataclasses.replace(configs.reduced(configs.get_config(arch)),
                              **changes)
    sched = dict(warmup=10, total=STEPS)
    ref_step = jax.jit(ref_make_train_step(
        RefModel(ref_cfg), RefAdamWConfig(lr=1e-3), None,
        microbatches=microbatches,
        schedule=lambda s: ref_cosine(s, **sched),
        bf16_compute_params=False))
    ref_params = RefModel(ref_cfg).init_params(jax.random.PRNGKey(0))
    params = convert.model_params_from_reference(
        jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    opt = adamw_init(params)
    ref_opt = ref_adamw_init(ref_params)
    step = make_train_step(Model(cfg), AdamWConfig(lr=1e-3),
                           microbatches=microbatches,
                           schedule=lambda s: cosine_schedule(s, **sched),
                           bf16_compute_params=False)
    pipe = RefTokenPipeline(RefPipelineConfig(vocab=cfg.vocab,
                                              seq_len=SEQ, global_batch=GB))
    for t in range(STEPS):
        rb = pipe.batch_at(t)
        ref_params, ref_opt, rm = ref_step(ref_params, ref_opt, rb)
        params, opt, m = step(params, opt,
                              convert.batch_from_reference(rb, "cpu"))
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                   rtol=1e-5, err_msg=f"step {t} loss")
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-5,
                                   err_msg=f"step {t} grad norm")
        np.testing.assert_allclose(float(m["lr"]), float(rm["lr"]),
                                   rtol=1e-6)
    assert int(opt.step) == STEPS


def _small(arch, **changes):
    return dataclasses.replace(configs.reduced(configs.get_config(arch)),
                               n_layers=2, vocab=256, remat="none",
                               **changes)


def test_microbatch_accumulation_matches_full_batch():
    """Accumulated GRADIENTS equal full-batch gradients (the reference's
    test); and the microbatched step is the step on those gradients."""
    cfg = _small("granite-3-8b")
    model = Model(cfg)
    params = model.init_params(0, device="cpu")
    batch = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=8,
                                         global_batch=4),
                          device="cpu").batch_at(0)
    l_full, g_full = _value_and_grad(model, params, batch, bf16=True)
    halves = [{k: v[2 * i:2 * i + 2] for k, v in batch.items()}
              for i in range(2)]
    parts = [_value_and_grad(model, params, h, bf16=True) for h in halves]
    l_acc = (parts[0][0] + parts[1][0]) / 2
    g_acc = T.tree_map(lambda a, b: (a + b) / 2, parts[0][1], parts[1][1])
    assert abs(float(l_full) - float(l_acc)) < 2e-2
    gn = sum(float(g.abs().sum()) for g in T.leaves(g_full))
    dn = sum(float((a - g).abs().sum())
             for a, g in zip(T.leaves(g_acc), T.leaves(g_full)))
    assert dn < 0.05 * gn

    opt_cfg = AdamWConfig(lr=1e-3)
    p2, o2 = _clone_state(params, adamw_init(params))
    p2, o2, m2 = make_train_step(model, opt_cfg, microbatches=2)(p2, o2,
                                                                 batch)
    assert torch.equal(m2["loss"], (parts[0][0] + parts[1][0])
                       / torch.tensor(2.0))
    g_sum = T.tree_map(lambda a, b: (a + b) / torch.tensor(2.0),
                       parts[0][1], parts[1][1])
    p3, o3 = _clone_state(params, adamw_init(params))
    p3, o3, _ = adamw_update(opt_cfg, g_sum, o3, p3)
    for a, b in zip(T.leaves(p2), T.leaves(p3)):
        assert torch.equal(a, b)


def test_bf16_compute_params_close_to_f32():
    cfg = _small("gemma-2b")
    model = Model(cfg)
    params = model.init_params(1, device="cpu")
    batch = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=8,
                                         global_batch=2),
                          device="cpu").batch_at(0)
    opt = AdamWConfig(lr=1e-3)
    out = {}
    for bf16 in (False, True):
        p, o = _clone_state(params, adamw_init(params))
        _, _, out[bf16] = make_train_step(
            model, opt, bf16_compute_params=bf16)(p, o, batch)
    assert abs(float(out[False]["loss"]) - float(out[True]["loss"])) < 0.05


def test_train_step_is_repeatable_and_in_place():
    cfg = _small("moonshot-v1-16b-a3b")
    model = Model(cfg)
    params, opt = init_train_state(model, 2, device="cpu")
    batch = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=8,
                                         global_batch=2),
                          device="cpu").batch_at(0)
    step = make_train_step(model, AdamWConfig())
    runs = []
    for _ in range(2):
        p, o = _clone_state(params, opt)
        p2, o2, m = step(p, o, batch)
        assert p2 is p and o2.mu is o.mu
        runs.append((p2, o2, m))
    for x, y in ((runs[0][0], runs[1][0]), (runs[0][1].mu, runs[1][1].mu),
                 (runs[0][1].nu, runs[1][1].nu)):
        for a, b in zip(T.leaves(x), T.leaves(y)):
            assert torch.equal(a, b)
    assert torch.equal(runs[0][2]["loss"], runs[1][2]["loss"])


# ------------------------------------------------------------- pipeline
def test_pipeline_deterministic_and_step_dependent():
    pipe = TokenPipeline(PipelineConfig(vocab=128, seq_len=16,
                                        global_batch=4), device="cpu")
    a, b, c = pipe.batch_at(3), pipe.batch_at(3), pipe.batch_at(4)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert a["tokens"].shape == a["labels"].shape == (4, 16)
    assert a["tokens"].dtype == torch.int64
    assert int(a["tokens"].max()) < 128 and int(a["tokens"].min()) >= 0
    # labels are next-token shifted views of one stream
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    other = TokenPipeline(PipelineConfig(vocab=128, seq_len=16,
                                         global_batch=4, seed=1),
                          device="cpu")
    assert not torch.equal(other.batch_at(3)["tokens"], a["tokens"])


def test_pipeline_host_sharding_partitions_batch():
    pipe = TokenPipeline(PipelineConfig(vocab=64, seq_len=8,
                                        global_batch=8), device="cpu")
    hosts = [pipe.batch_at(0, host_index=h, host_count=4) for h in range(4)]
    assert all(h["tokens"].shape == (2, 8) for h in hosts)
    for i in range(4):
        for j in range(i):
            assert not torch.equal(hosts[i]["tokens"], hosts[j]["tokens"])
    again = pipe.batch_at(0, host_index=2, host_count=4)
    assert torch.equal(again["tokens"], hosts[2]["tokens"])
    assert sum(h["tokens"].shape[0] for h in hosts) == 8


def _stats(batches, V):
    """(per-token frequency (V,), repeat share, count): the share of
    positions t ≥ 8 whose token is one of the 7 before it."""
    toks = np.concatenate([np.asarray(b) for b in batches])
    freq = np.bincount(toks.reshape(-1), minlength=V) / toks.size
    rep = np.zeros(toks[:, 8:].shape, dtype=bool)
    for d in range(1, 8):
        rep |= toks[:, 8:] == toks[:, 8 - d:toks.shape[1] - d]
    return freq, float(rep.mean()), rep.size


def test_pipeline_distribution_matches_reference():
    V, S, Bq, steps = 64, 128, 32, 4
    pcfg = dict(vocab=V, seq_len=S, global_batch=Bq)
    port = TokenPipeline(PipelineConfig(**pcfg), device="cpu")
    ref = RefTokenPipeline(RefPipelineConfig(**pcfg))
    f_p, r_p, n = _stats([port.batch_at(t)["tokens"].numpy()
                          for t in range(steps)], V)
    f_r, r_r, _ = _stats([ref.batch_at(t)["tokens"] for t in range(steps)],
                         V)
    N = steps * Bq * S
    zipf = np.arange(1, V + 1, dtype=np.float64) ** -1.2
    zipf /= zipf.sum()
    # copies are draws too, so the marginal stays Zipf; a copied token
    # repeats one nearby, so count positions as correlated in pairs
    sd = np.sqrt(2 * zipf * (1 - zipf) / N)
    assert np.all(np.abs(f_p - zipf) < 6 * sd), np.abs(f_p - zipf) / sd
    assert np.all(np.abs(f_p - f_r) < 6 * np.sqrt(2) * sd)
    sd_r = np.sqrt(2 * r_r * (1 - r_r) / n)
    assert abs(r_p - r_r) < 6 * np.sqrt(2) * sd_r, (r_p, r_r)
    assert r_p > 0.3                      # the copies are there


def test_pipeline_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TokenPipeline(PipelineConfig(vocab=8, seq_len=4, global_batch=2))


# ------------------------------------------------------------- launcher
def _reference_flags() -> dict:
    """{flag: default} of the reference launcher's parser, read from its
    source (it builds the parser inside main())."""
    src = ROOT / "src" / "repro" / "launch" / "train.py"
    flags = {}
    for node in ast.walk(ast.parse(src.read_text())):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "add_argument"):
            name = node.args[0].value
            kw = {k.arg: k.value for k in node.keywords}
            if "default" in kw:
                default = ast.literal_eval(kw["default"])
            elif "action" in kw:
                default = False
            else:
                default = None
            flags[name] = default
    return flags


def test_launcher_flags_are_the_references():
    want = _reference_flags()
    parser = launch.build_parser()
    got = {a.option_strings[0]: a.default for a in parser._actions
           if a.option_strings and a.option_strings[0] != "-h"}
    assert set(got) - set(want) == {"--device", "--log-every"}
    for flag, default in want.items():
        assert got[flag] == default, flag
    assert got["--log-every"] == 10 and got["--device"] is None


def _tiny():
    return dataclasses.replace(_small("granite-3-8b"), d_model=32,
                               d_ff=64)


def test_kill_and_resume_is_bitwise(tmp_path):
    cfg = _tiny()
    kw = dict(global_batch=2, seq_len=8, ckpt_every=10**6, lr=1e-3,
              device="cpu")
    p_full, l_full = launch.run_training(cfg, steps=6,
                                         ckpt_dir=str(tmp_path / "a"), **kw)
    _, l_a = launch.run_training(cfg, steps=3, ckpt_dir=str(tmp_path / "b"),
                                 **kw)
    p_res, l_b = launch.run_training(cfg, steps=6,
                                     ckpt_dir=str(tmp_path / "b"), **kw)
    assert l_a == l_full[:3] and l_b == l_full[3:]
    assert len(l_full) == 6
    for a, b in zip(T.leaves(p_full), T.leaves(p_res)):
        assert torch.equal(a, b)


def test_launcher_runs_and_resumes_in_a_subprocess(tmp_path):
    import chip_smoke
    args = ("repro_torch.launch.train", "--arch", "granite-3-8b",
            "--global-batch", "2", "--seq-len", "16", "--d-model", "32",
            "--layers", "2", "--device", "cpu", "--log-every", "1",
            "--ckpt-dir", str(tmp_path))
    out = chip_smoke.run_blocked(*args, "--steps", "3", timeout=180)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "step     2  loss" in out.stdout and "final loss" in out.stdout
    assert chip_smoke.runner_report(out.stdout)["leaked"] == []
    out = chip_smoke.run_blocked(*args, "--steps", "5", timeout=180)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "resumed from step 3" in out.stdout
    assert "step     3  loss" in out.stdout and "step     2" not in out.stdout


def test_launcher_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(["--arch", "gemma-2b", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.run_training(_tiny(), steps=1, global_batch=2, seq_len=4)


def test_train_lm_example_learns_on_cpu(capsys):
    from repro_torch.examples import train_lm
    out = train_lm.main(device="cpu", tiny=True)
    assert out["drop"] > 0.3 and len(out["losses"]) == 30
    assert "ms/step" in capsys.readouterr().out


# ------------------------------------------------------------- the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the stream and the step are "
                    "compared on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_pipeline_stream_is_the_same_on_the_card():
    dev = _card()
    pcfg = PipelineConfig(vocab=256_000, seq_len=64, global_batch=4)
    for step in (0, 5):
        a = TokenPipeline(pcfg, device="cpu").batch_at(step)
        b = TokenPipeline(pcfg, device=dev).batch_at(step)
        assert b["tokens"].device.type == "cuda"
        assert torch.equal(a["tokens"], b["tokens"].cpu())


@pytest.mark.cuda
def test_train_step_on_the_card_is_bitwise_repeatable():
    dev = _card()
    cfg = configs.reduced(configs.get_config("llama4-scout-17b-a16e"))
    model = Model(cfg)
    params, opt = init_train_state(model, 3, device=dev)
    batch = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=32,
                                         global_batch=4),
                          device=dev).batch_at(0)
    step = make_train_step(model, AdamWConfig(), microbatches=2)
    runs = []
    for _ in range(2):
        p, o = _clone_state(params, opt)
        runs.append(step(p, o, batch))
    for x, y in zip(runs[0][:2], runs[1][:2]):
        for a, b in zip(T.leaves(x), T.leaves(y)):
            assert torch.equal(a, b)
