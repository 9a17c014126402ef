"""Port of Algorithm 1 (`repro_torch.core.rank_table`) against the JAX
reference, stage by stage on the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rank_table as R
from repro.core.types import RankTableConfig as RefConfig
from repro_torch.core import rank_table as T
from repro_torch.core.types import RankTableConfig
from tests.conftest import make_problem


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads, so torch does not starve the timing-sensitive
    tests that share the run."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _t(x):
    return torch.from_numpy(np.array(x))


def _cfgs(**kw):
    return RefConfig(**kw), RankTableConfig(**kw)


@pytest.fixture(scope="module")
def problem():
    users, items = make_problem(jax.random.PRNGKey(3), n=300, m=250, d=24)
    return np.asarray(users), np.asarray(items)


@pytest.mark.parametrize("tau", [2, 37, 128])
def test_threshold_grid_matches_reference(tau):
    rng = np.random.default_rng(tau)
    smin = rng.normal(size=64).astype(np.float32) - 3.0
    smax = smin + rng.uniform(0.1, 5.0, size=64).astype(np.float32)
    want = np.asarray(R.threshold_grid(jnp.asarray(smin), jnp.asarray(smax),
                                       tau))
    got = T.threshold_grid(_t(smin), _t(smax), tau).numpy()
    # same f32 formula; XLA may contract the multiply-add: 1 ulp of |t|
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=1e-6)


@pytest.mark.parametrize("mode", ["sampled", "norm_bound", "exact"])
def test_threshold_range_matches_reference(problem, mode):
    users, items = problem
    ref_cfg, cfg = _cfgs(tau=16, threshold_mode=mode)
    items_sorted = np.asarray(R.sort_items_by_norm(jnp.asarray(items))[0])
    scores = users @ items_sorted[::7].T                  # any sample scores
    want = R._threshold_range(jnp.asarray(users), jnp.asarray(items_sorted),
                              jnp.asarray(scores), ref_cfg)
    got = T._threshold_range(_t(users), _t(items_sorted), _t(scores), cfg)
    for g, w in zip(got, want):
        # "sampled" reduces the given scores (exact); the other modes take
        # their own matmul / norms, which differ in the low bits
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("tau", [37, 128])
def test_estimate_table_rows_matches_reference(seed, tau):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(200, 96)).astype(np.float32)
    weights = rng.uniform(0.5, 3.0, size=96).astype(np.float32)
    thr = np.sort(rng.normal(size=(200, tau)).astype(np.float32), axis=1)
    want = np.asarray(R.estimate_table_rows(jnp.asarray(scores),
                                            jnp.asarray(weights),
                                            jnp.asarray(thr)))
    got = T.estimate_table_rows(_t(scores), _t(weights), _t(thr)).numpy()
    # the suffix sums add the same weights in another order (cumsum)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_sort_items_by_norm_matches_reference(problem):
    _, items = problem
    want_items, want_order = R.sort_items_by_norm(jnp.asarray(items))
    got_items, got_order = T.sort_items_by_norm(_t(items))
    np.testing.assert_array_equal(got_order.numpy(), np.asarray(want_order))
    np.testing.assert_array_equal(got_items.numpy(), np.asarray(want_items))


@pytest.mark.parametrize("kw", [dict(omega=4, s=8), dict(omega=3, s=200),
                                dict(omega=5, s=7,
                                     sample_with_replacement=True)])
def test_stratified_sampling_matches_reference_strata(kw):
    """The draws cannot match jax.random; the strata, the weights and the
    replacement rule do."""
    m = 250
    ref_cfg, cfg = _cfgs(**kw)
    _, want_w = R.stratified_sample_indices(jax.random.PRNGKey(0), m,
                                            ref_cfg)
    g = torch.Generator().manual_seed(0)
    pos, w = T.stratified_sample_indices(m, cfg, g)
    np.testing.assert_array_equal(w.numpy(), np.asarray(want_w))
    sizes = T.partition_sizes(m, cfg.omega)
    start = 0
    for l, size in enumerate(sizes):
        part = pos[l * cfg.s:(l + 1) * cfg.s].numpy()
        assert part.min() >= start and part.max() < start + size
        if not (cfg.sample_with_replacement or cfg.s > size):
            assert len(set(part.tolist())) == cfg.s
        start += size


def _near_weight(users, samples, weights, thr):
    """(n, τ) weight of the samples whose score lies within the f32
    rounding bound of two dot-product orders of a threshold."""
    sc = users.astype(np.float64) @ samples.T.astype(np.float64)
    eps = 2 * users.shape[1] * 2.0 ** -24 * (np.abs(users) @ np.abs(samples).T)
    near = np.abs(sc[:, :, None] - thr[:, None, :]) <= eps[:, :, None]
    return np.einsum("nst,s->nt", near, weights)


@pytest.mark.parametrize("mode,tau", [("sampled", 37), ("norm_bound", 64),
                                      ("exact", 128)])
def test_build_rank_table_sorted_matches_reference(problem, mode, tau):
    users, items = problem
    ref_cfg, cfg = _cfgs(tau=tau, omega=4, s=16, threshold_mode=mode)
    key = jax.random.PRNGKey(tau)
    items_sorted = np.asarray(R.sort_items_by_norm(jnp.asarray(items))[0])
    want = R.build_rank_table_sorted(jnp.asarray(users),
                                     jnp.asarray(items_sorted), ref_cfg, key)
    pos, w = R.stratified_sample_indices(key, items.shape[0], ref_cfg)
    got = T.build_rank_table_sorted(_t(users), _t(items_sorted), cfg,
                                    positions=_t(pos).long(), weights=_t(w))
    assert got.m == int(want.m)
    # thresholds come from the port's own sample scores: 1e-5 relative
    np.testing.assert_allclose(got.thresholds.numpy(),
                               np.asarray(want.thresholds), rtol=1e-5,
                               atol=1e-5)
    # the table is exact except where a sample score lies within the f32
    # rounding bound of a threshold; there it may move by that weight
    diff = np.abs(got.table.numpy() - np.asarray(want.table))
    samples = items_sorted[np.asarray(pos)]
    allowed = _near_weight(users, samples, np.asarray(w),
                           np.asarray(want.thresholds)) + 1e-5
    assert np.all(diff <= allowed)


def test_build_rank_table_sorts_then_builds(problem):
    users, items = problem
    ref_cfg, cfg = _cfgs(tau=32, omega=4, s=16)
    pos, w = R.stratified_sample_indices(jax.random.PRNGKey(9), 250, ref_cfg)
    full = T.build_rank_table(_t(users), _t(items), cfg, positions=_t(pos),
                              weights=_t(w))
    sorted_items, _ = T.sort_items_by_norm(_t(items))
    direct = T.build_rank_table_sorted(_t(users), sorted_items, cfg,
                                       positions=_t(pos), weights=_t(w))
    for a, b in zip(full, direct):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    assert full.m == direct.m == 250


def test_build_from_generator_is_deterministic(problem):
    users, items = problem
    cfg = RankTableConfig(tau=16, omega=4, s=8)
    a, b = (T.build_rank_table(_t(users), _t(items), cfg,
                               torch.Generator().manual_seed(5))
            for _ in range(2))
    assert torch.equal(a.table, b.table)
    assert torch.equal(a.thresholds, b.thresholds)
    # ascending thresholds, non-increasing table, ranks within [1, m + 1]
    assert bool((a.thresholds[:, 1:] >= a.thresholds[:, :-1]).all())
    assert bool((a.table[:, 1:] <= a.table[:, :-1]).all())
    assert float(a.table.min()) >= 1.0 and float(a.table.max()) <= 251.0


def test_positions_without_weights_raise(problem):
    users, items = problem
    with pytest.raises(ValueError, match="weights"):
        T.build_rank_table(_t(users), _t(items), RankTableConfig(tau=8),
                           positions=torch.arange(10))
