"""The port's AdamW and schedule (`repro_torch.train.optimizer`) against the
live reference (`repro.train.optimizer`), on the CPU.

The reference's own cases run on the port (convergence on a quadratic,
the clip bounding the first step, the global norm, the schedule's range
on a grid of steps); then `adamw_update` on converted trees — a stacked
model tree with moments after some steps, at lr_scale 1.0 and as a
schedule tensor, with and without clipping — against the reference's
(eager, as each op rounds on its own): grad norm, lr and the moments
within rtol 1e-6, the new parameters within 1e-6 of the larger of their
old and new magnitudes (p − lr·u cancels where lr·u ≈ p, so one rounding
of an operand moves the result by more than 1e-6 of itself); and
`cosine_schedule` against the reference's on a grid of steps, rtol 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as RO
from repro_torch import configs, convert
from repro_torch.models import transformer as T
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import AdamWConfig, OptState, \
    adamw_init, adamw_update, cosine_schedule, global_norm


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


# --------------------------------------------------- the reference's cases
def test_adamw_converges_on_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(params)
    for _ in range(200):
        g = {"w": 2 * params["w"]}
        params, state, _ = adamw_update(cfg, g, state, params)
    assert float((params["w"] ** 2).sum()) < 1e-3
    assert int(state.step) == 200 and state.step.dtype == torch.int32


def test_grad_clip_bounds_update():
    cfg = AdamWConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0)
    params = {"w": torch.zeros((3,))}
    huge = {"w": torch.full((3,), 1e6)}
    _, _, metrics = adamw_update(cfg, huge, adamw_init(params), params)
    assert float(metrics["grad_norm"]) > 1e5        # reported pre-clip
    params = {"w": torch.zeros((3,))}
    p2, _, _ = adamw_update(cfg, huge, adamw_init(params), params)
    assert float(p2["w"].abs().max()) <= 1.0 + 1e-5


def test_global_norm():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert abs(float(global_norm(t)) - 5.0) < 1e-6


def test_cosine_schedule_bounds():
    steps = torch.arange(0, 10_001, 7, dtype=torch.int32)
    v = cosine_schedule(steps, warmup=100, total=10_000)
    assert float(v.min()) >= 0.0 and float(v.max()) <= 1.0 + 1e-6


# ---------------------------------------------------- against the reference
def _tree(rng, cfg):
    """A parameter-shaped tree of random f32 arrays (numpy)."""
    shapes = jax.tree.map(lambda s: s.shape, T.abstract_params(cfg),
                          is_leaf=lambda x: isinstance(x, torch.Tensor))
    return jax.tree.map(
        lambda s: rng.normal(size=s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, torch.Size))


def _state(rng, cfg, step):
    mu = _tree(rng, cfg)
    nu = jax.tree.map(lambda a: np.abs(a) * 1e-2, _tree(rng, cfg))
    return RO.OptState(mu=mu, nu=nu, step=np.asarray(step, np.int32))


@pytest.mark.parametrize("case", ["clipped", "unclipped", "scheduled"])
def test_adamw_update_matches_reference(case):
    cfg = configs.reduced(configs.get_config("qwen3-32b"))
    rng = np.random.default_rng(11)
    params = _tree(rng, cfg)
    scale = 1.0 if case == "clipped" else 1e-4
    grads = jax.tree.map(lambda a: a * scale, _tree(rng, cfg))
    state = _state(rng, cfg, 6)
    opt = dict(lr=1e-3, weight_decay=0.1)
    ref_cfg = RO.AdamWConfig(**opt)
    lr_scale = 1.0
    port_scale = 1.0
    if case == "scheduled":
        lr_scale = RO.cosine_schedule(jnp.asarray(6, jnp.int32), warmup=3,
                                      total=40)
        port_scale = cosine_schedule(torch.tensor(6, dtype=torch.int32),
                                     warmup=3, total=40)
    want_p, want_s, want_m = RO.adamw_update(
        ref_cfg, jax.tree.map(jnp.asarray, grads),
        jax.tree.map(jnp.asarray, state), jax.tree.map(jnp.asarray, params),
        lr_scale)
    p = convert.model_params_from_reference(params, cfg, device="cpu")
    g = convert.model_params_from_reference(grads, cfg, device="cpu")
    s = convert.opt_state_from_reference(state, cfg, device="cpu")
    got_p, got_s, got_m = adamw_update(AdamWConfig(**opt), g, s, p,
                                       port_scale)
    assert got_p is p                                # in place
    assert int(got_s.step) == 7 and got_s.step.dtype == torch.int32
    clipped = float(want_m["grad_norm"]) > ref_cfg.grad_clip
    assert clipped == (case == "clipped")
    np.testing.assert_allclose(float(got_m["grad_norm"]),
                               float(want_m["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(got_m["lr"]), float(want_m["lr"]),
                               rtol=1e-6)
    old = dict(ckpt._paths(params))
    for name, got, want in (("params", got_p, want_p),
                            ("mu", got_s.mu, want_s.mu),
                            ("nu", got_s.nu, want_s.nu)):
        want = dict(ckpt._paths(want))
        got = dict(ckpt._paths(got))
        assert set(got) == set(want)
        for path, b in want.items():
            a, b = got[path].numpy(), np.asarray(b)
            scale = np.abs(b)
            if name == "params":
                # p − lr·u cancels where lr·u ≈ p: hold it to its operands
                scale = np.maximum(scale, np.abs(old[path]))
            bad = np.abs(a - b) > 1e-6 * scale
            assert not bad.any(), (name, path, a[bad][:4], b[bad][:4])


def test_adamw_init_and_global_norm_match_reference():
    cfg = configs.reduced(configs.get_config("gemma-2b"))
    rng = np.random.default_rng(12)
    tree = _tree(rng, cfg)
    p = convert.model_params_from_reference(tree, cfg, device="cpu")
    st = adamw_init(p)
    assert isinstance(st, OptState) and st.step.shape == () \
        and st.step.dtype == torch.int32 and int(st.step) == 0
    for a, b in zip(T.leaves(st.mu), T.leaves(p)):
        assert a.shape == b.shape and not bool(a.any())
    np.testing.assert_allclose(
        float(global_norm(p)),
        float(RO.global_norm(jax.tree.map(jnp.asarray, tree))), rtol=1e-6)


def test_cosine_schedule_matches_reference():
    grid = np.concatenate([np.arange(0, 60), np.arange(60, 10_001, 37)])
    for warmup, total in ((10, 200), (100, 10_000), (0, 50)):
        want = np.asarray(RO.cosine_schedule(jnp.asarray(grid, jnp.int32),
                                             warmup=warmup, total=total))
        got = cosine_schedule(torch.from_numpy(grid.astype(np.int32)),
                              warmup=warmup, total=total).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_lr_metric_is_the_scaled_rate():
    cfg = AdamWConfig(lr=3e-4)
    params = {"w": torch.ones((2, 2))}
    _, _, m = adamw_update(cfg, {"w": torch.ones((2, 2))},
                           adamw_init(params), params, 0.5)
    assert float(m["lr"]) == float(np.float32(1.5e-4))
    assert dataclasses.asdict(cfg)["b2"] == 0.95
