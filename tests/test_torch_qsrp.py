"""The port's QSRP baseline (`repro_torch.core.qsrp`) against the JAX
reference (`repro/core/qsrp.py`):

  cases      the reference's four QSRP cases and its metric definitions
             (`tests/test_qsrp.py`) on the port, on the reference's data;
  columns    the summary keeps the reference's columns (computed as its
             `jit` computes them) at every size tried, and `ranks_at` is
             the reference's;
  summary    bitwise the reference's on integer inputs (±0.0 compared as
             values: the two sorts may order them differently);
  query      indices, ranks and n_refined equal to the reference's at
             c ∈ {1, 2, 4} on integer inputs (every score exact), both
             the accepted branch and the refinement;
  chunks     the index does not depend on the user chunk size.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qsrp as RQ
from repro_torch.core import metrics
from repro_torch.core import qsrp as Q
from repro_torch.core.exact import exact_ranks, reverse_k_ranks
from tests.conftest import make_problem


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
    """`tests/test_qsrp.py`'s problem, carried across through numpy."""
    users, items = make_problem(jax.random.PRNGKey(33), n=600, m=500, d=24)
    users, items = (torch.from_numpy(np.array(x)) for x in (users, items))
    return users, items, Q.build_qsrp_index(users, items, levels=100,
                                            block=256)


def int_problem(seed=0, n=600, m=500, d=24):
    rng = np.random.default_rng(seed)
    return (rng.integers(-3, 4, (n, d)).astype(np.float32),
            rng.integers(-3, 4, (m, d)).astype(np.float32))


# ------------------------------------------- the reference's four cases
def test_qsrp_bounds_always_valid(problem):
    """Quantile summaries are true order statistics, so the bounds are
    exact (unlike the rank table's estimates)."""
    users, items, idx = problem
    for qi in [0, 10, 499]:
        q = items[qi]
        r_lo, r_up = (x.numpy() for x in Q._bounds_from_summary(idx,
                                                                users @ q))
        truth = exact_ranks(users, items, q).numpy()
        assert np.all(r_lo <= truth)
        assert np.all(truth <= r_up)
        assert np.all(r_up - r_lo <= np.ceil(500 / 99) + 1)


@pytest.mark.parametrize("c", [1.0, 2.0, 4.0])
def test_qsrp_accuracy_always_one(problem, c):
    """Def. 3 with the reference's one-rank slack for float ties."""
    users, items, idx = problem
    for qi in [3, 77]:
        q = items[qi]
        truth = exact_ranks(users, items, q).numpy()
        ex_idx, _ = reverse_k_ranks(users, items, q, 10)
        got_idx, got_ranks, _ = Q.qsrp_query(idx, users, items, q, 10, c)
        ours = np.sort(truth[got_idx]).astype(np.float64)
        exact = np.sort(truth[ex_idx.numpy()]).astype(np.float64)
        assert np.all(ours <= c * exact + 1)
        np.testing.assert_allclose(got_ranks, truth[got_idx], atol=2)


def test_qsrp_c1_equals_exact(problem):
    users, items, idx = problem
    q = items[42]
    truth = exact_ranks(users, items, q).numpy()
    _, ex_ranks = reverse_k_ranks(users, items, q, 15)
    got_idx, _, _ = Q.qsrp_query(idx, users, items, q, 15, 1.0)
    np.testing.assert_allclose(np.sort(truth[got_idx]),
                               np.sort(ex_ranks.numpy()), atol=1)


def test_larger_c_refines_no_more(problem):
    """A larger c accepts more users by Lemma 1 (1), so the refinement
    cannot grow with c (the Fig. 4 trend)."""
    users, items, idx = problem
    q = items[8]
    refined = [Q.qsrp_query(idx, users, items, q, 10, c)[2]
               for c in (1.0, 2.0, 4.0, 8.0)]
    assert all(a >= b for a, b in zip(refined, refined[1:]))


def test_metrics_definitions():
    true_ranks = np.array([5, 1, 10, 100, 3])
    exact_idx = np.array([1, 4, 0])           # ranks 1, 3, 5
    ours_idx = np.array([1, 0, 2])            # ranks 1, 5, 10
    assert metrics.accuracy(ours_idx, exact_idx, true_ranks, c=2.0) == 1.0
    np.testing.assert_allclose(
        metrics.overall_ratio(ours_idx, exact_idx, true_ranks),
        np.mean([1 / 1, 5 / 3, 10 / 5]))


# -------------------------------------------------- against the reference
def _ref_columns(m, levels):
    """The columns the reference's `_summarize_block` keeps, read off a
    one-user problem whose sorted scores are m - 1, m - 2, ..., 0."""
    items = jnp.asarray(np.arange(m, dtype=np.float32)[:, None])
    out = np.asarray(RQ._summarize_block(jnp.ones((1, 1), jnp.float32),
                                         items, levels))[0]
    return (m - 1 - out).astype(np.int64)


@pytest.mark.parametrize("m, levels", [(17_770, 1000), (500, 100),
                                       (2000, 128), (800, 64),
                                       (99_999, 2000), (123_457, 1000)])
def test_columns_are_the_references(m, levels):
    """At (99,999, 2,000) and (123,457, 1,000) the reference's f32
    reciprocal product differs from the IEEE quotient; the port follows
    the reference."""
    np.testing.assert_array_equal(Q._columns(m, levels, "cpu").numpy(),
                                  _ref_columns(m, levels))


@pytest.mark.parametrize("seed", [0, 1])
def test_summary_is_the_references(seed):
    users, items = int_problem(seed)
    want = RQ.build_qsrp_index(jnp.asarray(users), jnp.asarray(items),
                               levels=100, block=256)
    got = Q.build_qsrp_index(torch.from_numpy(users),
                             torch.from_numpy(items), levels=100, block=256)
    # == compares values: +0.0 and -0.0 are equal
    assert np.all(got.quantile_scores.numpy()
                  == np.asarray(want.quantile_scores))
    np.testing.assert_array_equal(got.ranks_at.numpy(),
                                  np.asarray(want.ranks_at))
    assert got.ranks_at.dtype == torch.int32 and got.m == int(want.m)
    # the bounds of a query bitwise too
    q = items[7]
    for a, b in zip(Q._bounds_from_summary(got, torch.from_numpy(users @ q)),
                    RQ._bounds_from_summary(want, jnp.asarray(users @ q))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("c", [1.0, 2.0, 4.0])
def test_query_is_the_references(c):
    users, items = int_problem(2)
    ridx = RQ.build_qsrp_index(jnp.asarray(users), jnp.asarray(items),
                               levels=100, block=256)
    pidx = Q.build_qsrp_index(torch.from_numpy(users),
                              torch.from_numpy(items), levels=100)
    branches = set()
    for qi in (3, 8, 77, 140, 311):
        want = RQ.qsrp_query(ridx, jnp.asarray(users), jnp.asarray(items),
                             jnp.asarray(items[qi]), 10, c)
        got = Q.qsrp_query(pidx, torch.from_numpy(users),
                           torch.from_numpy(items),
                           torch.from_numpy(items[qi]), 10, c)
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        assert got[0].dtype == np.int32
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))
        assert got[1].dtype == np.asarray(want[1]).dtype
        assert got[2] == want[2]
        branches.add(got[2] > 0)
    if c == 1.0:
        assert branches == {True}
    if c == 4.0:
        assert False in branches          # the accepted branch ran


def test_index_does_not_depend_on_the_chunk():
    users, items = (torch.from_numpy(x) for x in int_problem(3, n=300))
    a = Q.build_qsrp_index(users, items, levels=50, block=7)
    b = Q.build_qsrp_index(users, items, levels=50, block=1024)
    assert torch.equal(a.quantile_scores, b.quantile_scores)
