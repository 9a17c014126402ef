"""The port's kernel wrappers (`repro_torch.kernels`) against the JAX
reference: the plain versions against `repro.kernels.ref` and against the
Pallas kernels in interpret mode (as tests/test_kernels.py runs them), at
ragged small shapes.

Users and items hold small integers, so every dot product is exact in
f32 whatever the summation order: scores, and with them the bucketize
indices and counts, are then identical in both packages, and the bounds
and counts are compared exactly. Only est (division, exp) and weighted
sums of non-dyadic weights get a float tolerance, stated per test.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.rank_table import build_rank_table
from repro.core.types import RankTableConfig as RefConfig
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import _build, ops, ref

N = 300


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads, so torch does not starve the timing-sensitive
    tests that share the run."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _int_problem(seed, n=N, m=200, d=24):
    rng = np.random.default_rng(seed)
    users = rng.integers(-4, 5, (n, d)).astype(np.float32)
    items = rng.integers(-4, 5, (m, d)).astype(np.float32)
    return users, items


@pytest.fixture(scope="module", params=[37, 128])
def table(request):
    """A reference rank table over an integer problem, τ ∈ {37, 128}."""
    import jax
    tau = request.param
    users, items = _int_problem(tau)
    rt = build_rank_table(jnp.asarray(users), jnp.asarray(items),
                          RefConfig(tau=tau, omega=4, s=16),
                          jax.random.PRNGKey(tau))
    return (users, items, np.asarray(rt.thresholds), np.asarray(rt.table),
            int(rt.m))


def _t(x):
    return torch.from_numpy(np.array(x))


# est: same scores, same formula; division and exp may differ by an ulp,
# which the interpolation scales by at most the table step: 1e-5 relative.
EST_RTOL = 1e-5


@pytest.mark.parametrize("B", [1, 3, 16])
def test_ref_bound_ranks_matches_reference_ref(table, B):
    users, items, thr, tab, m = table
    qs = items[np.arange(B) * 7 % items.shape[0]]
    got = ref.ref_bound_ranks(_t(users), _t(qs), _t(thr), _t(tab), m)
    for b in range(B):
        want = rref.ref_bound_ranks(jnp.asarray(users), jnp.asarray(qs[b]),
                                    jnp.asarray(thr), jnp.asarray(tab), m)
        np.testing.assert_array_equal(got[0][:, b].numpy(),
                                      np.asarray(want[0]))
        np.testing.assert_array_equal(got[1][:, b].numpy(),
                                      np.asarray(want[1]))
        np.testing.assert_allclose(got[2][:, b].numpy(), np.asarray(want[2]),
                                   rtol=EST_RTOL)


@pytest.mark.parametrize("B", [1, 3, 16])
def test_bound_ranks_batched_matches_pallas_interpret(table, B):
    users, items, thr, tab, m = table
    qs = items[np.arange(B) * 11 % items.shape[0]]
    got = ops.bound_ranks_batched(_t(users), _t(qs), _t(thr), _t(tab), m=m)
    want = rops.bound_ranks_batched(jnp.asarray(users), jnp.asarray(qs),
                                    jnp.asarray(thr), jnp.asarray(tab), m=m)
    for g, w in zip(got[:2], want[:2]):
        assert g.shape == (B, N)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=EST_RTOL)


def test_bound_ranks_single_matches_pallas_interpret(table):
    users, items, thr, tab, m = table
    q = items[5]
    got = ops.bound_ranks(_t(users), _t(q), _t(thr), _t(tab), m=m)
    want = rops.bound_ranks(jnp.asarray(users), jnp.asarray(q),
                            jnp.asarray(thr), jnp.asarray(tab), m=m)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=EST_RTOL)


def _edge_step1(tau, seed, n=N, d=24, B=19, m=777):
    """Integer users and queries (exact scores), and ascending thresholds
    rows that hold the user's own scores (scores exactly on a threshold)
    and other integers, in runs of three equal values; rows 0-9 lie above
    every score of the row and rows 10-19 below it. The table rows
    descend."""
    rng = np.random.default_rng(seed)
    users = rng.integers(-4, 5, (n, d)).astype(np.float32)
    qs = rng.integers(-4, 5, (B, d)).astype(np.float32)
    sc = users @ qs.T
    own = np.take_along_axis(sc, rng.integers(0, B, (n, tau)), axis=1)
    thr = np.where(rng.random((n, tau)) < 0.5, own,
                   rng.integers(-40, 41, (n, tau)))
    thr = np.repeat(thr[:, :(tau + 2) // 3], 3, axis=1)[:, :tau]
    step = np.arange(tau)
    thr[:10] = sc[:10].max(axis=1, keepdims=True) + 1 + step
    thr[10:20] = sc[10:20].min(axis=1, keepdims=True) - 1 - tau + step
    thr = np.sort(thr, axis=1).astype(np.float32)
    tab = np.sort(rng.uniform(1.0, m, (n, tau)), axis=1)[:, ::-1]
    return users, qs, thr, np.ascontiguousarray(tab, np.float32), m


@pytest.mark.parametrize("pruned", [False, True])
@pytest.mark.parametrize("B", [1, 19])
@pytest.mark.parametrize("tau", [1, 2, 33])
def test_f32_step1_edges_match_pallas_interpret(tau, B, pruned):
    """What K1/K6's search must keep, on the port's CPU path against the
    Pallas kernels in interpret mode: τ of 1, 2 and 33; runs of equal
    thresholds; integer scores exactly on a threshold, above the grid and
    below it (idx = τ and 0); B = 19 (two launches on the card); K6 over a
    tail tile past n and duplicate ids, its rows past n at m + 2.
    r_lo/r_up bitwise, est within EST_RTOL."""
    users, qs, thr, tab, m = _edge_step1(tau, 100 * tau + B)
    args = (users, qs, thr, tab)
    if pruned:
        bn, ids = 64, np.array([4, 0, 2, 2], np.int32)
        got = ops.bound_ranks_batched_pruned(*map(_t, args), _t(ids), m=m,
                                             block_n=bn)
        want = rops.bound_ranks_batched_pruned(*map(jnp.asarray, args),
                                               jnp.asarray(ids), m=m,
                                               block_n=bn)
        rows = (ids[:, None] * bn + np.arange(bn)).reshape(-1)
        live = rows < N
        for g in got:
            assert bool((g[:, ~live] == m + 2).all())
    else:
        got = ops.bound_ranks_batched(*map(_t, args), m=m)
        want = rops.bound_ranks_batched(*map(jnp.asarray, args), m=m)
        live = np.ones(N, bool)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy()[:, live],
                                      np.asarray(w)[:, live])
    np.testing.assert_allclose(got[2].numpy()[:, live],
                               np.asarray(want[2])[:, live], rtol=EST_RTOL)
    r_lo, r_up = (x.numpy()[:, live] for x in got[:2])
    if not pruned:       # the rows off the grid sit at its edges
        assert (r_up[:, :10] == m + 1).all() and (r_lo[:, 10:20] == 1).all()


def _table_inputs(seed, n, S, tau, dyadic):
    rng = np.random.default_rng(seed)
    users = rng.integers(-4, 5, (n, 20)).astype(np.float32)
    samples = rng.integers(-4, 5, (S, 20)).astype(np.float32)
    if dyadic:
        weights = np.full(S, 1777 / 64, np.float32)   # Netflix's |P_l|/s
    else:
        weights = rng.uniform(0.5, 3.0, S).astype(np.float32)
    # half-integer thresholds never tie an integer score
    thr = np.sort(rng.integers(-40, 40, (n, tau)), axis=1) + 0.5
    return users, samples, weights, thr.astype(np.float32)


@pytest.mark.parametrize("n,S,tau", [(300, 40, 37), (200, 64, 128)])
@pytest.mark.parametrize("dyadic", [True, False])
def test_table_rows_match_reference(n, S, tau, dyadic):
    users, samples, weights, thr = _table_inputs(n + S, n, S, tau, dyadic)
    got = ops.build_table_rows(_t(users), _t(samples), _t(weights), _t(thr))
    want_ref = rref.ref_table_rows(jnp.asarray(users), jnp.asarray(samples),
                                   jnp.asarray(weights), jnp.asarray(thr))
    want_kernel = rops.build_table_rows(
        jnp.asarray(users), jnp.asarray(samples), jnp.asarray(weights),
        jnp.asarray(thr))
    for want in (want_ref, want_kernel):
        if dyadic:
            # equal dyadic weights: every partial sum is exact in f32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            # the same weights summed in another order
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5)


def test_table_rows_match_sorted_estimator():
    """The direct-count version `ref_table_rows` equals the sort + suffix
    path that the wrapper runs on the CPU, on the same scores."""
    from repro_torch.core.rank_table import estimate_table_rows
    users, samples, weights, thr = _table_inputs(3, 150, 48, 50, True)
    got = ref.ref_table_rows(_t(users), _t(samples), _t(weights), _t(thr))
    want = estimate_table_rows(_t(users) @ _t(samples).T, _t(weights),
                               _t(thr))
    assert torch.equal(got, want)
    assert torch.equal(ops.build_table_rows(_t(users), _t(samples),
                                            _t(weights), _t(thr)), want)


def _rearranged(thr, order, rng):
    """Rows of thresholds `thr` (n, τ) as they are ("ascending"),
    reversed ("descending") or each shuffled on its own ("shuffled")."""
    if order == "descending":
        thr = thr[:, ::-1]
    elif order == "shuffled":
        thr = rng.permuted(thr, axis=1)
    return np.ascontiguousarray(thr)


@pytest.mark.parametrize("order", ["descending", "shuffled"])
def test_table_rows_take_thresholds_in_any_order(order):
    """The sort + suffix + search form (`estimate_table_rows`: the
    wrapper's CPU path, and the form K2 computes on the card) places each
    threshold by a search of its own, so a row of thresholds may hold any
    order. On descending and on shuffled rows it equals the direct count
    of both packages (`ref_table_rows`) and the Pallas kernel in interpret
    mode, bitwise with dyadic weights (every partial sum exact). Integer
    scores meet half-integer thresholds, integer thresholds that tie them
    (a tie does not count) and ±0.0, against user 0's scores, all zero
    (the plain version fed -0.0 for half of them as well)."""
    rng = np.random.default_rng(23)
    users, samples, weights, thr = _table_inputs(17, 150, 48, 40, True)
    users[0] = 0.0
    thr[:, :3] = [-0.0, 0.0, -1.0]
    thr[:, 3:9] = np.floor(thr[:, 3:9])
    thr = _rearranged(np.sort(thr, axis=1), order, rng)
    args = (users, samples, weights, thr)
    got = ops.build_table_rows(*map(_t, args))
    want_torch = ref.ref_table_rows(*map(_t, args))
    want_ref = rref.ref_table_rows(*map(jnp.asarray, args))
    want_kernel = rops.build_table_rows(*map(jnp.asarray, args))
    for want in (want_torch, want_ref, want_kernel):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    zero = np.isin(thr[0], [0.0, -1.0])
    np.testing.assert_array_equal(
        got[0].numpy()[zero],
        np.where(thr[0][zero] < 0, 1 + weights.sum(), 1.0))
    scores = _t(users) @ _t(samples).T
    scores[0, ::2] = -0.0
    np.testing.assert_array_equal(
        ref.estimate_table_rows(scores, _t(weights), _t(thr)).numpy(),
        got.numpy())


@pytest.mark.parametrize("n,m", [(300, 700), (64, 100)])
@pytest.mark.parametrize("q_in_p", [True, False])
def test_exact_ranks_match_reference(n, m, q_in_p):
    users, items = _int_problem(n + m, n=n, m=m, d=33)
    q = items[2] if q_in_p else np.random.default_rng(1).integers(
        -4, 5, 33).astype(np.float32)
    got = ops.exact_ranks(_t(users), _t(items), _t(q))
    assert got.dtype == torch.int32
    want_ref = 1 + np.asarray(rref.ref_exact_counts(
        jnp.asarray(users), jnp.asarray(items), jnp.asarray(q)))
    want_kernel = np.asarray(rops.exact_ranks(
        jnp.asarray(users), jnp.asarray(items), jnp.asarray(q)))
    np.testing.assert_array_equal(got.numpy(), want_ref)
    np.testing.assert_array_equal(got.numpy(), want_kernel)


def test_exact_counts_blocking_is_invisible():
    users, items = _int_problem(4, n=300, m=90)
    q = _t(items[3])
    a = ref.ref_exact_counts(_t(users), _t(items), q, block=7)
    b = ref.ref_exact_counts(_t(users), _t(items), q)
    assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "ndim"])
def test_wrappers_reject_malformed_inputs(bad):
    users = torch.zeros(10, 4)
    qs = torch.zeros(2, 4)
    thr = torch.zeros(10, 6)
    tab = torch.ones(10, 6)
    if bad == "dtype":
        users = users.double()
    elif bad == "shape":
        qs = torch.zeros(2, 5)
    elif bad == "contiguity":
        thr = torch.zeros(6, 10).T
    else:
        qs = torch.zeros(4)
    with pytest.raises((TypeError, ValueError)):
        ops.bound_ranks_batched(users, qs, thr, tab, m=5)


def _quant_state(spec):
    """A small packed table and stored users for the K4/K5 wrapper."""
    from repro_torch.core.types import StorageSpec
    users, _ = _int_problem(3, n=10, m=4, d=4)
    thr = torch.arange(60, dtype=torch.float32).reshape(10, 6)
    st = StorageSpec.parse(spec)
    return (st.pack_table(thr, torch.flip(thr, [1]) + 1.0, m=5),
            st.pack_users(_t(users)))


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "ndim",
                                 "vector"])
@pytest.mark.parametrize("spec", ["bf16", "int8"])
def test_stored_wrapper_rejects_malformed_inputs(spec, bad):
    rt, su = _quant_state(spec)
    qs = torch.zeros(2, 4)
    if bad == "dtype":
        su = su._replace(rows=su.rows.to(torch.float16))
    elif bad == "shape":
        qs = torch.zeros(2, 5)
    elif bad == "contiguity":
        rt = rt._replace(table=torch.zeros(6, 10, dtype=rt.table.dtype).T)
    elif bad == "ndim":
        qs = torch.zeros(4)
    else:
        su = su._replace(row_slack=su.row_slack[:5])
    with pytest.raises((TypeError, ValueError)):
        ops.bound_ranks_batched_stored(su, qs, rt)


def test_cpu_path_launches_nothing_and_builds_nothing():
    before = dict(ops.LAUNCHES)
    users, items = _int_problem(0, n=20, m=10, d=4)
    ops.exact_ranks(_t(users), _t(items), _t(items[0]))
    ops.build_table_rows(_t(users), _t(items), torch.ones(10),
                         torch.zeros(20, 3))
    ops.bound_ranks(_t(users), _t(items[0]), torch.zeros(20, 3),
                    torch.ones(20, 3), m=10)
    for spec in ("bf16", "int8"):
        rt, su = _quant_state(spec)
        ops.bound_ranks_batched_stored(su, torch.ones(3, 4), rt)
        ops.bound_ranks_batched_stored(torch.ones(10, 4), torch.ones(1, 4),
                                       rt)
    assert ops.LAUNCHES == before
    assert _build._LIBS == {}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["k1", "k2", "k3"])
def test_kernel_matches_plain_on_card(kernel):
    """Each CUDA kernel against its plain version on the card, on integer
    inputs (exact scores in any order). Run on a machine with a GPU:
    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels.py"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    users, items = _int_problem(9, n=1000, m=777, d=37)
    U, P = _t(users).to(dev), _t(items).to(dev)
    if kernel == "k1":
        rng = np.random.default_rng(2)
        thr = _t(np.sort(rng.integers(-60, 60, (1000, 37)), axis=1) + 0.5
                 ).float().to(dev)
        tab = torch.flip(torch.cumsum(torch.rand(1000, 37, device=dev),
                                      1), [1]).contiguous() + 1.0
        for B in (1, 2, 3, 6, 16, 19):
            qs = P[:B].contiguous()
            got = ops.bound_ranks_batched(U, qs, thr, tab, m=777)
            want = ref.ref_bound_ranks(U, qs, thr, tab, 777)
            assert torch.equal(got[0], want[0].T)
            assert torch.equal(got[1], want[1].T)
            torch.testing.assert_close(got[2], want[2].T, rtol=EST_RTOL,
                                       atol=0)
    elif kernel == "k2":
        users, samples, weights, thr = _table_inputs(5, 1000, 640, 500, True)
        args = [_t(x).to(dev) for x in (users, samples, weights, thr)]
        assert torch.equal(ops.build_table_rows(*args),
                           ref.ref_table_rows(*args))
    else:
        for q in (P[11], _t(users[0]).to(dev)):
            assert torch.equal(ops.exact_ranks(U, P, q.contiguous()),
                               1 + ref.ref_exact_counts(U, P, q))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [40, 640, 777, 4096])
def test_table_build_at_its_edges_on_card(S):
    """K2 on the card at its edges, on integer inputs (every score exact
    in any order): part of a sample tile (S = 40, 777), Netflix's 640, and
    4,096 samples (four runs of the count); τ ∈ {1, 37, 500, 1,031};
    d ∈ {37, the last depth whose user tile stays resident and the next,
    1,031}; rows of thresholds ascending, descending and shuffled, with
    integer thresholds on scores and ±0.0 against user 0's zero scores;
    views from row 1 of every input. With weights whose sums are exact
    (integers, equal dyadic, or equal in runs of 64 samples) the table is
    bitwise `ref_table_rows` and two launches agree; with
    non-dyadic weights it is within 1e-5 relative. Run on a machine with
    a GPU: PYTHONPATH=src python -m pytest -m cuda
    tests/test_torch_kernels.py"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.kernels import table_build
    dev = torch.device("cuda")
    cap = max(d for d in range(200, 260)
              if table_build.launch_config(1, d, S)["users_resident"])
    rng = np.random.default_rng(S)
    for d, tau in ((37, 1), (37, 37), (37, 500), (37, 1031), (cap, 37),
                   (cap + 1, 500), (1031, 37)):
        n = 300
        users = rng.integers(-4, 5, (n, d)).astype(np.float32)
        samples = rng.integers(-4, 5, (S, d)).astype(np.float32)
        users[0] = 0.0
        top = int(np.abs(users @ samples.T).max()) + 2
        thr = (rng.integers(-top, top, (n, tau))
               + 0.5 * rng.integers(0, 2, (n, tau))).astype(np.float32)
        thr[0, :2] = [-0.0, 0.0][:tau]
        U, Pm = _t(users).to(dev), _t(samples).to(dev)
        # integer weights (each sorts with its key), Netflix's equal
        # 1777/64 (keys sort alone) and one integer a run of 64 samples
        # (parts of either kind)
        for wts in (rng.integers(1, 4, S), np.full(S, 1777 / 64),
                    np.repeat(rng.integers(1, 4, S // 64 + 1), 64)[:S]):
            W = _t(wts.astype(np.float32)).to(dev)
            for order in ("ascending", "descending", "shuffled"):
                T = _t(_rearranged(np.sort(thr, axis=1), order, rng)).to(dev)
                got = ops.build_table_rows(U, Pm, W, T)
                assert torch.equal(got, ref.ref_table_rows(U, Pm, W, T)), \
                    (d, tau, order)
                assert torch.equal(got, ops.build_table_rows(U, Pm, W, T))
        T = _t(thr).to(dev)
        assert torch.equal(ops.build_table_rows(U[1:], Pm[1:], W[1:], T[1:]),
                           ref.ref_table_rows(U[1:], Pm[1:], W[1:], T[1:]))
        Wr = _t(rng.uniform(0.5, 3.0, S).astype(np.float32)).to(dev)
        torch.testing.assert_close(ops.build_table_rows(U, Pm, Wr, T),
                                   ref.ref_table_rows(U, Pm, Wr, T),
                                   rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tile", "depth", "tau", "queries", "ties",
                                  "views"])
def test_k1_at_its_edges_on_card(case):
    """K1 at the edges of its ring on the card, on integer inputs (every
    score exact in any order): bounds bitwise the plain version's, est
    within 1e-5. Cases (`chip_smoke.k1_edges`, which phase 3 runs too): n
    below one tile and one past it; d in 1, 37, 200, 1,031, 30,000 (rows
    in chunks); tau in 1, 2, 37, 500, 777 and 30,000 (thresholds rows past
    a stage); B in 1, 2, 3, 6, 16, 19 with query 0 bitwise the same at
    every B (integer and randn inputs); runs of equal thresholds with
    scores on them, above and below the grid; views from row 1 of users,
    thresholds and table. Run on a machine with a GPU:
    PYTHONPATH=src:. python -m pytest -m cuda tests/test_torch_kernels.py"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.core import pruning
    from repro_torch.kernels import user_scores
    chip_smoke.k1_edges(torch, ops, ref, user_scores, pruning, case)
