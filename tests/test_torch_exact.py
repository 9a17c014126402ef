"""The port's exact oracle and §5 metrics against the JAX reference."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as ref_metrics
from repro.core.exact import exact_rank_single as ref_exact_single
from repro.core.exact import exact_ranks as ref_exact_ranks
from repro.core.exact import reverse_k_ranks as ref_reverse_k_ranks
from repro_torch.core import metrics
from repro_torch.core.exact import exact_rank_single, exact_ranks, \
    reverse_k_ranks


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads, so torch does not starve the timing-sensitive
    tests that share the run."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _problem(seed, integer, n=512, m=400, d=16):
    rng = np.random.default_rng(seed)
    if integer:
        # exact dot products in any order: ranks compare exactly
        return (rng.integers(-4, 5, (n, d)).astype(np.float32),
                rng.integers(-4, 5, (m, d)).astype(np.float32))
    return (rng.normal(size=(n, d)).astype(np.float32),
            (rng.normal(size=(m, d)) * np.abs(
                1 + 0.3 * rng.normal(size=(m, 1)))).astype(np.float32))


def _query(items, q_in_p, seed):
    if q_in_p:
        return items[7]
    return np.random.default_rng(seed + 100).normal(
        size=items.shape[1]).astype(np.float32)


@pytest.mark.parametrize("q_in_p", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_exact_ranks_equal_reference_on_exact_scores(seed, q_in_p):
    users, items = _problem(seed, integer=True)
    q = items[7] if q_in_p else np.ones(16, np.float32)
    got = exact_ranks(torch.from_numpy(users), torch.from_numpy(items),
                      torch.from_numpy(q))
    want = ref_exact_ranks(jnp.asarray(users), jnp.asarray(items),
                           jnp.asarray(q))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    idx, rk = reverse_k_ranks(torch.from_numpy(users),
                              torch.from_numpy(items), torch.from_numpy(q),
                              10)
    widx, wrk = ref_reverse_k_ranks(jnp.asarray(users), jnp.asarray(items),
                                    jnp.asarray(q), 10)
    # equal ranks, ties to the lower user index in both
    np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))
    np.testing.assert_array_equal(rk.numpy(), np.asarray(wrk))


@pytest.mark.parametrize("q_in_p", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_exact_ranks_match_reference_up_to_rounding_ties(seed, q_in_p):
    """Float data: a rank may differ only by the number of items whose
    score lies within the f32 rounding bound of u·q (for q ∈ P, the item
    equal to q is such a tie in the reference's separate u·q product)."""
    users, items = _problem(seed, integer=False)
    q = _query(items, q_in_p, seed)
    got = exact_ranks(torch.from_numpy(users), torch.from_numpy(items),
                      torch.from_numpy(q)).numpy()
    want = np.asarray(ref_exact_ranks(jnp.asarray(users), jnp.asarray(items),
                                      jnp.asarray(q)))
    up = users.astype(np.float64) @ items.T.astype(np.float64)
    uq = users.astype(np.float64) @ q.astype(np.float64)
    eps = 2 * 2 * 16 * 2.0 ** -24 * (np.abs(users) @ np.abs(items).T
                                     + (np.abs(users) @ np.abs(q))[:, None])
    n_near = (np.abs(up - uq[:, None]) <= eps).sum(axis=1)
    assert np.all(np.abs(got - want) <= n_near)
    if q_in_p:
        # the port takes u·q from the same product as u·p: the self item
        # never counts against itself
        assert np.all(got <= want)


def test_exact_rank_single_and_blocking():
    users, items = _problem(3, integer=False, n=100, m=60)
    U, P = torch.from_numpy(users), torch.from_numpy(items)
    q = _query(items, False, 3)
    full = exact_ranks(U, P, torch.from_numpy(q))
    assert torch.equal(exact_ranks(U, P, torch.from_numpy(q), block=7), full)
    for i in (0, 17, 99):
        single = int(exact_rank_single(U[i], P, torch.from_numpy(q)))
        assert single == int(ref_exact_single(
            jnp.asarray(users[i]), jnp.asarray(items), jnp.asarray(q)))
        assert single == int(full[i])


@pytest.mark.parametrize("c", [1.0, 1.5, 2.0])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_reference(seed, c):
    rng = np.random.default_rng(seed)
    true_ranks = rng.integers(1, 500, 300)
    exact_idx = np.argsort(true_ranks, kind="stable")[:10]
    result_idx = rng.choice(300, 10, replace=False)
    assert metrics.accuracy(result_idx, exact_idx, true_ranks, c) == \
        ref_metrics.accuracy(result_idx, exact_idx, true_ranks, c)
    assert metrics.overall_ratio(result_idx, exact_idx, true_ranks) == \
        ref_metrics.overall_ratio(result_idx, exact_idx, true_ranks)
    assert metrics.accuracy(exact_idx, exact_idx, true_ranks, c) == 1.0
    assert metrics.overall_ratio(exact_idx, exact_idx, true_ranks) == 1.0


def _offset_view(x):
    """x's values in a contiguous view 4 bytes past a 16-byte boundary."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 37, 200, 328, 1031])
def test_exact_kernel_matches_plain_on_card(d):
    """K3 on the card against its plain version, on integer inputs (exact
    scores in any order, so the ranks must be equal), at ragged n and m
    around its 128-user block and 256-item tile, at depths that fill its
    ring by 4-byte copies (d = 1, 37, 1,031) and by bulk copies (d = 200,
    328), with its user tile resident (d <= 200) and staged (d = 328,
    1,031), on views U[1:] and P[1:] and on rows 4 bytes past a 16-byte
    boundary (4-byte copies at every d), and with q ∈ P. Run on a machine
    with a GPU:
    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_exact.py"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    users, items = _problem(d, integer=True, n=300, m=300, d=d)
    U, P = torch.from_numpy(users).to(dev), torch.from_numpy(items).to(dev)
    plain = lambda u, p, q: 1 + ref.ref_exact_counts(u, p, q)
    for n in (1, 63, 64, 65, 129, 257):
        for m in (1, 63, 64, 65, 129, 257):
            for q in (P[m - 1], P[0] + 1.0):
                got = ops.exact_ranks(U[:n], P[:m], q.contiguous())
                assert got.dtype == torch.int32
                assert torch.equal(got, plain(U[:n], P[:m], q))
    q = P[7].contiguous()
    for u, p in ((U[1:], P), (U, P[1:]), (U[1:], P[1:]),
                 (_offset_view(U), _offset_view(P))):
        assert torch.equal(ops.exact_ranks(u, p, q), plain(u, p, q))
