"""The slice as a whole: the quickstart flow (build → query_batch/query
→ exact grading with the §5 metrics) through the port's engine against
the JAX reference's, on the same embeddings and the same Algorithm-1
samples, at a small size (n = 2048, m = 1024, d = 32, τ = 64)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as ref_metrics
from repro.core.engine import ReverseKRanksEngine as RefEngine
from repro.core.exact import exact_ranks as ref_exact_ranks
from repro.core.exact import reverse_k_ranks as ref_reverse_k_ranks
from repro.core.rank_table import stratified_sample_indices
from repro.core.types import RankTableConfig as RefConfig
from repro.data.pipeline import synthetic_embeddings as ref_synthetic
from repro_torch.convert import from_reference
from repro_torch.core import metrics
from repro_torch.core.engine import ReverseKRanksEngine
from repro_torch.core.exact import exact_ranks, reverse_k_ranks
from repro_torch.core.types import RankTableConfig
from repro_torch.data.pipeline import synthetic_embeddings

N, M, D, TAU = 2048, 1024, 32, 64
K, C = 10, 2.0
QIDS = [42, 0, 7, 100, 511, 700, 901, 1023]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads, so torch does not starve the timing-sensitive
    tests that share the run."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def flow():
    """The reference's quickstart flow, and its state carried across."""
    users, items = ref_synthetic(jax.random.PRNGKey(0), N, M, D)
    cfg = RefConfig(tau=TAU)
    key = jax.random.PRNGKey(1)
    eng = RefEngine.build(users, items, cfg, key)
    qs = items[jnp.asarray(QIDS)]
    res = eng.query_batch(qs, K, C)
    truth = [np.asarray(ref_exact_ranks(users, items, qs[b]))
             for b in range(len(QIDS))]
    exact_idx = [np.asarray(ref_reverse_k_ranks(users, items, qs[b], K)[0])
                 for b in range(len(QIDS))]
    pos, w = stratified_sample_indices(key, M, cfg)
    st = from_reference(eng.rank_table, users, items, pos, w, device="cpu")
    return dict(ref_engine=eng, ref_res=res, truth=truth,
                exact_idx=exact_idx, state=st, mem=eng.memory_bytes())


def _metrics(mod, indices, exact_idx, truth):
    acc = [mod.accuracy(np.asarray(i), e, t, C)
           for i, e, t in zip(indices, exact_idx, truth)]
    ratio = [mod.overall_ratio(np.asarray(i), e, t)
             for i, e, t in zip(indices, exact_idx, truth)]
    return acc, ratio


@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_quickstart_flow_matches_reference(flow, backend):
    st = flow["state"]
    eng = ReverseKRanksEngine.build(st.users, st.items, RankTableConfig(
        tau=TAU), None, backend=backend, device="cpu",
        positions=st.positions, weights=st.weights)
    assert eng.backend_name == backend
    assert eng.memory_bytes() == flow["mem"]
    # Algorithm 1 on the same samples: thresholds to 1e-5 relative
    np.testing.assert_allclose(
        eng.rank_table.thresholds.numpy(),
        np.asarray(flow["ref_engine"].rank_table.thresholds), rtol=1e-5,
        atol=1e-5)
    qs = st.items[torch.tensor(QIDS)]
    res = eng.query_batch(qs, K, C)
    one = eng.query(st.items[42], K, C)
    assert torch.equal(one.indices, res.indices[0])

    truth = [exact_ranks(st.users, st.items, qs[b]).numpy()
             for b in range(len(QIDS))]
    exact_idx = [reverse_k_ranks(st.users, st.items, qs[b], K)[0].numpy()
                 for b in range(len(QIDS))]
    # ranks: equal up to the self-item tie the reference may round either
    # way (the port takes u·q from the same product as u·p)
    for ours, theirs in zip(truth, flow["truth"]):
        assert np.all((theirs - ours >= 0) & (theirs - ours <= 1))

    ref_idx = np.asarray(flow["ref_res"].indices)
    same_sets = [set(a) == set(b) for a, b in zip(res.indices.tolist(),
                                                  ref_idx.tolist())]
    assert all(same_sets), same_sets
    # equal selections graded by equal oracles: equal §5 metrics
    ours = _metrics(metrics, res.indices.numpy(), exact_idx, truth)
    theirs = _metrics(ref_metrics, ref_idx, flow["exact_idx"], flow["truth"])
    np.testing.assert_allclose(ours, theirs, rtol=1e-12)


def test_engine_rejects_bad_queries_and_backends(flow):
    st = flow["state"]
    eng = ReverseKRanksEngine(st.users, st.rank_table, RankTableConfig(
        tau=TAU))
    with pytest.raises(ValueError, match="query_batch expects"):
        eng.query_batch(st.items[0], K, C)
    with pytest.raises(ValueError, match="query expects"):
        eng.query(st.items[:2], K, C)
    with pytest.raises(ValueError, match="unknown query backend"):
        ReverseKRanksEngine(st.users, st.rank_table, RankTableConfig(),
                            backend="sharded")
    with pytest.raises(ValueError, match="unknown backend wrapper"):
        ReverseKRanksEngine(st.users, st.rank_table, RankTableConfig(),
                            backend="sharded:fused")
    # the cached and elastic wrappers resolve (lazily imported)
    for spec in ("cached:fused", "elastic:fused"):
        assert ReverseKRanksEngine(st.users, st.rank_table,
                                   RankTableConfig(),
                                   backend=spec).backend_name == spec
    assert ReverseKRanksEngine.backends() == ["dense", "fused", "pruned"]
    assert (eng.n, eng.d) == (N, D)


def test_from_reference_carries_state_exactly(flow):
    st = flow["state"]
    rt = flow["ref_engine"].rank_table
    np.testing.assert_array_equal(st.rank_table.table.numpy(),
                                  np.asarray(rt.table))
    assert st.rank_table.m == int(rt.m) == M
    assert st.positions.dtype == torch.int64
    assert st.users.dtype == torch.float32 and st.users.shape == (N, D)


@pytest.mark.parametrize("strength", [0.0, 1.0])
def test_synthetic_embeddings_match_reference_distribution(strength):
    """The draws differ from jax.random's; shapes, determinism in the
    seed and the norm statistics match: mean norms to 5% at this size,
    and without clusters also their spread (with clusters the spread
    hangs on the 32 random centres, too few to compare)."""
    kw = dict(cluster_strength=strength)
    u1, i1 = synthetic_embeddings(0, 4000, 3000, 32, device="cpu", **kw)
    u2, i2 = synthetic_embeddings(0, 4000, 3000, 32, device="cpu", **kw)
    assert torch.equal(u1, u2) and torch.equal(i1, i2)
    assert u1.shape == (4000, 32) and i1.dtype == torch.float32
    ru, ri = ref_synthetic(jax.random.PRNGKey(0), 4000, 3000, 32, **kw)
    for ours, theirs in ((u1, ru), (i1, ri)):
        a = torch.linalg.norm(ours, dim=1).numpy()
        b = np.linalg.norm(np.asarray(theirs), axis=1)
        np.testing.assert_allclose(a.mean(), b.mean(), rtol=0.05)
        if strength == 0.0:
            np.testing.assert_allclose(a.std(), b.std(), rtol=0.05)
