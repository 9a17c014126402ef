"""The port's §4.3 query (`repro_torch.core.query`) against the JAX
reference, each stage on the reference's own inputs: the reference's
`RankTable` and scores go into the port's lookup, the reference's bounds
into the port's selection, so drift in one stage cannot hide in the next.

Tolerances: bounds are table gathers, exact given identical scores; est
agrees to 1e-5 relative (division and exp may differ by an ulp);
selections agree modulo ties of the selection key.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.query import lookup_bounds_batch as ref_lookup
from repro.core.query import query_batch as ref_query_batch
from repro.core.query import select_topk as ref_select_topk
from repro.core.rank_table import build_rank_table
from repro.core.types import RankTableConfig as RefConfig
from repro_torch.convert import from_reference
from repro_torch.core import query as Q
from repro_torch.core.engine import ReverseKRanksEngine
from repro_torch.core.types import RankTableConfig
from tests.conftest import make_problem

K = 7
EST_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads, so torch does not starve the timing-sensitive
    tests that share the run."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def problem():
    return make_problem(jax.random.PRNGKey(42), n=512, m=400, d=16)


@pytest.fixture(scope="module")
def tables(problem):
    """Both Lemma-1 regimes, built as tests/test_storage.py builds them:
    an exact-range fine table (c = 4, guaranteed) and a coarse one
    (c = 1, not guaranteed)."""
    users, items = problem
    exact = dict(tau=128, omega=4, s=items.shape[0] // 4,
                 threshold_mode="exact")
    coarse = dict(tau=16, omega=4, s=8)
    return {
        "guaranteed": (exact, build_rank_table(
            users, items, RefConfig(**exact), jax.random.PRNGKey(0)), 4.0),
        "non_guaranteed": (coarse, build_rank_table(
            users, items, RefConfig(**coarse), jax.random.PRNGKey(1)), 1.0),
    }


def _qs(problem, B):
    users, items = problem
    return np.asarray(items)[np.arange(B) * 13 % items.shape[0]]


def _ref_state(problem, rt):
    users, items = problem
    return from_reference(rt, users, items, device="cpu")


def assert_same_selection(got_idx, want_idx, key, k, tol=0.0):
    """Row-wise equal index sets, except users whose key ties the k-th
    key within `tol` (either may be chosen)."""
    got_idx, want_idx = np.asarray(got_idx), np.asarray(want_idx)
    key = np.asarray(key)
    for b in range(got_idx.shape[0]):
        kth = np.sort(key[b])[k - 1]
        for u in set(got_idx[b].tolist()) ^ set(want_idx[b].tolist()):
            assert key[b, u] <= kth + tol, (b, u, key[b, u], kth)


@pytest.mark.parametrize("B", [1, 3, 16])
@pytest.mark.parametrize("regime", ["guaranteed", "non_guaranteed"])
def test_lookup_exact_given_identical_scores(problem, tables, regime, B):
    _, rt, _ = tables[regime]
    users, _ = problem
    scores = np.array(users @ jnp.asarray(_qs(problem, B)).T)
    want = ref_lookup(rt, jnp.asarray(scores))
    got = Q.lookup_bounds_batch(_ref_state(problem, rt).rank_table,
                                torch.from_numpy(scores))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=EST_RTOL)


@pytest.mark.parametrize("B", [1, 3, 16])
@pytest.mark.parametrize("regime", ["guaranteed", "non_guaranteed"])
def test_selection_matches_given_identical_bounds(problem, tables, regime,
                                                  B):
    _, rt, c = tables[regime]
    users, _ = problem
    scores = users @ jnp.asarray(_qs(problem, B)).T
    r_lo, r_up, est = (np.array(x).T for x in ref_lookup(rt, scores))
    want = ref_select_topk(jnp.asarray(r_lo), jnp.asarray(r_up),
                           jnp.asarray(est), k=K, c=c, m_items=rt.m)
    got = Q.select_topk(torch.from_numpy(r_lo), torch.from_numpy(r_up),
                        torch.from_numpy(est), k=K, c=c, m_items=int(rt.m))
    for f in ("R_lo_k", "R_up_k", "guaranteed", "n_accepted", "n_pruned"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    assert bool(want.guaranteed.all()) == (regime == "guaranteed")
    key = Q.lemma1_key(torch.from_numpy(r_lo), torch.from_numpy(r_up),
                       torch.from_numpy(est), R_lo_k=got.R_lo_k,
                       R_up_k=got.R_up_k, c=c, m_items=int(rt.m))[0]
    assert_same_selection(got.indices, want.indices, key, K)
    np.testing.assert_allclose(np.sort(got.est_rank.numpy(), axis=1),
                               np.sort(np.asarray(want.est_rank), axis=1),
                               rtol=EST_RTOL)


@pytest.mark.parametrize("backend", ["dense", "fused"])
@pytest.mark.parametrize("B", [1, 3, 16])
@pytest.mark.parametrize("regime", ["guaranteed", "non_guaranteed"])
def test_query_batch_matches_reference(problem, tables, regime, B, backend):
    """The whole query on the port's own scores against the reference's:
    users whose bounds differ must have a score within the f32 rounding
    bound of a threshold; selections agree modulo ties."""
    kw, rt, c = tables[regime]
    st = _ref_state(problem, rt)
    qs = _qs(problem, B)
    eng = ReverseKRanksEngine(st.users, st.rank_table, RankTableConfig(**kw),
                              backend=backend)
    got = eng.query_batch(torch.from_numpy(qs), K, c)
    want = ref_query_batch(rt, problem[0], jnp.asarray(qs), K, c)
    users = st.users.numpy()
    scores = (users.astype(np.float64) @ qs.T.astype(np.float64)).T
    eps = 2 * users.shape[1] * 2.0 ** -24 * (np.abs(users) @ np.abs(qs).T).T
    thr = st.rank_table.thresholds.numpy()
    near = (np.abs(scores[:, :, None] - thr[None]) <= eps[:, :, None]
            ).any(axis=2)
    flips = (got.r_lo.numpy() != np.asarray(want.r_lo)) | (
        got.r_up.numpy() != np.asarray(want.r_up))
    assert not np.any(flips & ~near)
    bounds = Q.bound_ranks_batch(st.rank_table, st.users,
                                 torch.from_numpy(qs))
    key = Q.lemma1_key(*bounds, R_lo_k=got.R_lo_k, R_up_k=got.R_up_k, c=c,
                       m_items=st.rank_table.m)[0].numpy()
    for b in range(B):
        if flips[b].any():
            continue        # a flipped bound may move the order statistics
        assert float(got.R_lo_k[b]) == float(want.R_lo_k[b])
        assert float(got.R_up_k[b]) == float(want.R_up_k[b])
        # est from two score orders: scores within eps move est by
        # < 1e-3 rank units at these sizes; ties inside that band may swap
        assert_same_selection(got.indices[b:b + 1],
                              np.asarray(want.indices)[b:b + 1],
                              key[b:b + 1], K, tol=1e-3)
    assert flips.mean() < 0.01


def test_bucketize_is_searchsorted_right():
    rng = np.random.default_rng(0)
    thr = np.sort(rng.integers(-5, 5, (40, 9)), axis=1).astype(np.float32)
    uq = rng.integers(-6, 6, (40, 3)).astype(np.float32)
    got = Q._bucketize(torch.from_numpy(thr), torch.from_numpy(uq)).numpy()
    want = np.stack([np.searchsorted(thr[i], uq[i], side="right")
                     for i in range(40)])
    np.testing.assert_array_equal(got, want)


def test_selection_breaks_ties_to_lower_index():
    key = torch.tensor([[3.0, 1.0, 1.0, 0.0, 1.0, 1.0]])
    assert Q.smallest_k(key, 3).tolist() == [[3, 1, 2]]
    assert jax.lax.top_k(-jnp.asarray(key.numpy()), 3)[1].tolist() == \
        [[3, 1, 2]]


def test_query_is_the_batch_of_one(problem, tables):
    kw, rt, c = tables["non_guaranteed"]
    st = _ref_state(problem, rt)
    q = torch.from_numpy(_qs(problem, 1)[0])
    one = Q.query(st.rank_table, st.users, q, K, c)
    batch = Q.query_batch(st.rank_table, st.users, q[None], K, c)
    for a, b in zip(one, batch):
        assert torch.equal(a, b[0])
