"""The port's row-sharded execution (`repro_torch.core.distributed`, the
"sharded" backend, `pruned:sharded`) against the JAX reference, on the
CPU, with P shards that share the CPU (a mesh that repeats a device):

  P = 1      the sharded backend bitwise the reference's
             `make_batch_query_fn` on a one-device mesh (every field, the
             (B, k·P) candidate-set bounds included), at every spec;
  P > 1      indices, R↓_k and R↑_k bitwise the reference's
             single-device `query_batch`, and every field bitwise the
             port's `select_topk` over the concatenated shard bounds;
  delta      `with_delta` on a correction converted from a mutated
             reference engine;
  wrappers   the build and `align` fallbacks, `check_users_shape` at the
             append and at a compacting rebuild, `cached:`, `elastic:`
             and `pruned:sharded`, `restore(..., mesh=)`, the auditor;
  schedule   one step of each cross-shard collective a call, whatever B
             (the reference's SCHEDULE_OK);
  8 devices  `python tests/test_torch_distributed.py` forces 8 host
             devices for the reference and holds the port at P = 8
             bitwise against its `build_sharded`, both query functions
             and `ring_exact_ranks`; one test runs it in one subprocess.

Users, items and queries are integer-valued, so every score is exact in
any summation order; the scenario's table has a zero range pad and
τ = 65 (a dyadic grid step), so that both packages' thresholds are exact
too. The phase-8 checks of `chip_smoke.py` run on the card in the test
marked `cuda`.
"""
import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               + os.environ.get("XLA_FLAGS", ""))

import subprocess                                             # noqa: E402
import tempfile                                               # noqa: E402
from pathlib import Path                                      # noqa: E402

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402
import numpy as np                                            # noqa: E402
import pytest                                                 # noqa: E402
import torch                                                  # noqa: E402

from repro.core import distributed as RD                      # noqa: E402
from repro.core import rank_table as RT                       # noqa: E402
from repro.core.engine import ReverseKRanksEngine as RefEngine  # noqa: E402
from repro.core.query import query_batch as ref_query_batch   # noqa: E402
from repro.core.types import RankTableConfig as RefConfig     # noqa: E402
from repro_torch import convert                               # noqa: E402
from repro_torch.core import backends as BK                   # noqa: E402
from repro_torch.core import distributed as D                 # noqa: E402
from repro_torch.core import query as Q                       # noqa: E402
from repro_torch.core import rank_table as T                  # noqa: E402
from repro_torch.core.engine import ReverseKRanksEngine       # noqa: E402
from repro_torch.core.types import RankTableConfig            # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N, M, D_, K, C = 1024, 512, 16, 10, 2.0
SPECS = ("f32", "bf16", "int8")
REF_SPEC = {"f32": "float32", "bf16": "bfloat16", "int8": "int8"}
GRID = dict(tau=65, omega=4, s=16, range_pad=0.0)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads, so torch does not starve the timing-sensitive
    tests that share the run."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def int_problem(seed=0, n=N, m=M, d=D_, clusters=0):
    """Integer-valued users and items from numpy; with `clusters`, users
    come cluster-contiguous around integer centers (blocks prune)."""
    rng = np.random.default_rng(seed)
    if clusters:
        centers = rng.integers(-8, 9, (clusters, d))
        users = centers[np.arange(n) * clusters // n] \
            + rng.integers(-1, 2, (n, d))
        items = centers[rng.integers(0, clusters, m)] \
            + rng.integers(-1, 2, (m, d))
    else:
        users = rng.integers(-4, 5, (n, d))
        items = rng.integers(-4, 5, (m, d))
    return users.astype(np.float32), items.astype(np.float32)


def mesh(P):
    return (CPU,) * P


def ref_state(spec, users, items, key=1, **grid):
    """The reference's table (and stored users) at `spec`, and the same
    state converted to the port: (ref rt, ref users, port rt, port
    users), users raw at f32 and `StoredUsers` otherwise."""
    rcfg = RefConfig(**(grid or GRID), storage_dtype=REF_SPEC[spec])
    rt = RT.build_rank_table(jnp.asarray(users), jnp.asarray(items), rcfg,
                             jax.random.PRNGKey(key))
    ru = (jnp.asarray(users) if spec == "f32"
          else rcfg.storage.pack_users(jnp.asarray(users)))
    st = convert.from_reference(rt, users, stored_users=None
                                if spec == "f32" else ru, device="cpu")
    return rt, ru, st.rank_table, (st.users if spec == "f32"
                                   else st.stored_users)


def queries(items, B, seed=3):
    """B integer-valued queries, items and off-item mixtures."""
    rng = np.random.default_rng(seed)
    return (items[rng.integers(0, items.shape[0], B)]
            + rng.integers(-1, 2, (B, items.shape[1]))).astype(np.float32)


def assert_fields(got, want, fields=None):
    for f in fields or want._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
            err_msg=f)


# ------------------------------------------------------------------ mesh
def test_flat_mesh():
    assert D.flat_mesh("cpu") == (CPU,)
    assert D.flat_mesh(["cpu", CPU, "cpu"]) == (CPU,) * 3
    assert D.flat_mesh(device="cpu") == (CPU,)
    with pytest.raises(ValueError, match="at least one device"):
        D.flat_mesh([])


def test_shards_are_row_views_cached_per_tensor():
    users, items = int_problem()
    _, _, rt, u = ref_state("int8", users, items)
    rts, us, cs = D.split_state(rt, u, None, mesh(4))
    for s in range(4):
        rows = slice(s * N // 4, (s + 1) * N // 4)
        assert rts[s].table.data_ptr() == rt.table[rows].data_ptr()
        assert torch.equal(rts[s].thr_dev, rt.thr_dev[rows])
        assert torch.equal(us[s].scale, u.scale[rows])
        assert rts[s].m == rt.m and cs[s] is None
    assert D.split_state(rt, u, None, mesh(4))[0] is rts   # cached
    with pytest.raises(ValueError, match="split evenly"):
        D.shard_rows(torch.zeros(10, 2), mesh(4))


# ------------------------------------------------------- the sharded query
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("B", [1, 16])
def test_p1_is_the_references_sharded_query(spec, B):
    """At P = 1 every field, the candidate-set bounds included, is the
    reference's `make_batch_query_fn` on a one-device mesh; at int8 the
    reference run op by op (under `jit` XLA contracts the dequantization
    `code·sc + off` into an FMA, ROADMAP's port rules)."""
    users, items = int_problem()
    rt, ru, prt, pu = ref_state(spec, users, items)
    qs = queries(items, B)
    fn = RD.make_batch_query_fn(RD.flat_mesh(jax.devices()[:1]), k=K, n=N,
                                c=C)
    with jax.disable_jit(spec == "int8"):
        want = fn(rt, ru, jnp.asarray(qs))
    got = BK.get_backend("sharded", mesh=mesh(1)).query_batch(
        prt, pu, torch.from_numpy(qs), k=K, c=C)
    assert got.r_lo.shape == (B, K)
    assert_fields(got, want)


@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("B", [1, 16])
def test_sharded_selects_as_the_reference_single_device(P, B):
    users, items = int_problem(seed=P)
    rt, ru, prt, pu = ref_state("f32", users, items)
    qs = queries(items, B, seed=P)
    want = ref_query_batch(rt, ru, jnp.asarray(qs), K, C)
    got = BK.ShardedBackend(mesh(P)).query_batch(
        prt, pu, torch.from_numpy(qs), k=K, c=C)
    assert got.r_lo.shape == (B, K * P)
    assert_fields(got, want, ("indices", "R_lo_k", "R_up_k", "guaranteed"))


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("P", [2, 4])
def test_merge_is_select_topk_over_the_shard_bounds(spec, P):
    """The tree merge selects what `select_topk` selects over the
    concatenated shards' own bounds, fields bitwise (n_accepted and
    n_pruned count over the candidates, as in the reference)."""
    users, items = int_problem(seed=10 + P)
    _, _, rt, u = ref_state(spec, users, items)
    qs = torch.from_numpy(queries(items, 5))
    got = BK.ShardedBackend(mesh(P)).query_batch(rt, u, qs, k=K, c=C)
    bounds = D.shard_bounds(mesh(P), rt, u, qs)
    want = Q.select_topk(*bounds, k=K, c=C, m_items=rt.m)
    assert_fields(got, want, ("indices", "est_rank", "R_lo_k", "R_up_k",
                              "guaranteed"))
    # the shard bounds are the dense bounds (integer inputs)
    for a, b in zip(bounds, Q.bound_ranks_batch(rt, u, qs)):
        assert torch.equal(a, b)
    one = D.make_query_fn(mesh(P), k=K, n=N, c=C)(rt, u, qs[2])
    assert_fields(one, Q.squeeze_result(D.make_batch_query_fn(
        mesh(P), k=K, n=N, c=C)(rt, u, qs[2:3])))


def test_k_past_a_shard_and_uneven_n_raise():
    users, items = int_problem(n=96, m=64)
    _, _, rt, u = ref_state("f32", users, items)
    qs = torch.from_numpy(queries(items, 2))
    with pytest.raises(ValueError, match="rows a shard holds"):
        BK.ShardedBackend(mesh(4)).query_batch(rt, u, qs, k=30, c=C)
    with pytest.raises(ValueError, match="split evenly"):
        D.make_batch_query_fn(mesh(5), k=K, n=96, c=C)


@pytest.mark.parametrize("B", [1, 16])
def test_collectives_do_not_grow_with_the_batch(B):
    """One gather of the order statistics, one send back, one gather of
    the candidates a call: the count does not depend on B (nor on P)."""
    users, items = int_problem(clusters=8)
    _, _, rt, u = ref_state("f32", users, items)
    qs = torch.from_numpy(queries(items, B))
    for backend in (BK.ShardedBackend(mesh(4)),
                    BK.PrunedBackend("sharded", mesh=mesh(4), block_size=64,
                                     max_union_frac=1.0)):
        D.reset_collective_counts()
        backend.query_batch(rt, u, qs, k=K, c=C)
        assert D.COLLECTIVES == {"gather_stats": 1, "send_stats": 1,
                                 "gather_candidates": 1}


# --------------------------------------------------------------- the delta
@pytest.fixture(scope="module")
def mutated():
    """A reference engine after inserts, deletes and user deletions, and
    its snapshot converted to the port."""
    users, items_all = int_problem(seed=5, m=M + 16)
    items, new = items_all[:M], items_all[M:]
    ref = RefEngine.build(jnp.asarray(users), jnp.asarray(items),
                          RefConfig(**GRID), jax.random.PRNGKey(1))
    ref.insert_items(jnp.asarray(new))
    ref.delete_items([3, 17, 40])
    ref.delete_users([9, N - 100])
    snap = ref.current_snapshot()
    st = convert.from_reference(snap.rank_table, snap.users, device="cpu")
    corr = convert.correction_from_reference(snap.corr, device="cpu")
    return dict(snap=snap, rt=st.rank_table, users=st.users, corr=corr,
                qs=queries(items, 8))


def test_p1_delta_is_the_references(mutated):
    snap, qs = mutated["snap"], mutated["qs"]
    fn = RD.make_batch_query_fn(RD.flat_mesh(jax.devices()[:1]), k=K, n=N,
                                c=C, with_delta=True)
    want = fn(snap.rank_table, snap.users, jnp.asarray(qs), snap.corr)
    got = BK.ShardedBackend(mesh(1)).query_batch(
        mutated["rt"], mutated["users"], torch.from_numpy(qs), k=K, c=C,
        delta=mutated["corr"])
    assert_fields(got, want)


@pytest.mark.parametrize("P", [2, 4])
def test_delta_on_shards_selects_as_the_dense_delta(mutated, P):
    rt, users, corr = mutated["rt"], mutated["users"], mutated["corr"]
    qs = torch.from_numpy(mutated["qs"])
    got = BK.ShardedBackend(mesh(P)).query_batch(rt, users, qs, k=K, c=C,
                                                 delta=corr)
    want = Q.query_batch_delta(rt, users, qs, corr, K, C)
    assert_fields(got, want, ("indices", "est_rank", "R_lo_k", "R_up_k",
                              "guaranteed"))
    dead = {9, N - 100}
    assert not dead & set(got.indices.flatten().tolist())
    pr = BK.PrunedBackend("sharded", mesh=mesh(P), block_size=64,
                          max_union_frac=1.0)
    assert_fields(pr.query_batch(rt, users, qs, k=K, c=C, delta=corr), want,
                  ("indices", "R_lo_k", "R_up_k"))
    assert pr.stats.fallback == ""


# ------------------------------------------------- build, pruned, wrappers
@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("spec", ["f32", "int8"])
def test_sharded_build_is_the_dense_build(P, spec):
    """On integer inputs every shard's product is exact, so the sharded
    build (K2's plain version once a shard) is bitwise the dense one."""
    users, items = map(torch.from_numpy, int_problem(seed=20 + P))
    cfg = RankTableConfig(tau=32, omega=4, s=16, storage_dtype=spec)
    eng = ReverseKRanksEngine.build(users, items, cfg, 7,
                                    backend="sharded", device="cpu",
                                    mesh=mesh(P))
    assert eng._backend.build_fallback == "" and eng.mesh == mesh(P)
    ref = ReverseKRanksEngine.build(users, items, cfg, 7, backend="dense",
                                    device="cpu")
    for a, b in zip(eng.rank_table, ref.rank_table):
        assert (a == b) if isinstance(a, int) else (
            a is None and b is None or torch.equal(a, b))


def test_build_fallbacks_and_refusal():
    """n or m off the mesh multiple, and the exact threshold mode, build
    dense, and say so; `build_sharded` itself refuses the exact mode."""
    users, items = int_problem()
    bk = BK.ShardedBackend(mesh(3))
    cfg = RankTableConfig(tau=32, omega=4, s=16)
    g = torch.Generator().manual_seed(0)
    pos, w = T.stratified_sample_indices(M, cfg, g)
    rt = bk.build_index(torch.from_numpy(users), torch.from_numpy(items),
                        cfg, positions=pos, weights=w)
    assert bk.build_fallback == "shape"                  # 1024 % 3, 512 % 3
    exact = RankTableConfig(tau=32, omega=4, s=16, threshold_mode="exact")
    BK.ShardedBackend(mesh(2)).build_index(
        torch.from_numpy(users), torch.from_numpy(items), exact,
        positions=pos, weights=w)
    with pytest.raises(ValueError, match="exact"):
        D.build_sharded(torch.from_numpy(users), torch.from_numpy(items),
                        exact, pos, w, mesh(2))
    want = BK.DenseBackend().build_index(
        torch.from_numpy(users), torch.from_numpy(items), cfg,
        positions=pos, weights=w)
    assert torch.equal(rt.table, want.table)


@pytest.mark.parametrize("P", [1, 2, 4])
def test_pruned_sharded_prunes_and_selects_as_the_full_scan(P):
    users, items = int_problem(seed=30, clusters=16)
    rt, ru, prt, pu = ref_state("f32", users, items)
    qs = queries(items, 8, seed=31)
    pr = BK.PrunedBackend("sharded", mesh=mesh(P), block_size=64,
                          max_union_frac=1.0)
    got = pr.query_batch(prt, pu, torch.from_numpy(qs), k=K, c=C)
    assert pr.stats.fallback == "" and pr.stats.skip_rate > 0
    full = BK.ShardedBackend(mesh(P)).query_batch(
        prt, pu, torch.from_numpy(qs), k=K, c=C)
    assert_fields(got, full, ("indices", "R_lo_k", "R_up_k", "guaranteed"))
    if P == 1:
        # every field the reference's pruned:sharded on one device
        rpr = RD.make_pruned_batch_query_fn(
            RD.flat_mesh(jax.devices()[:1]), k=K, n=N, c=C, block_size=64)
        ids = np.zeros((1, 16), np.int32)
        ids[0] = np.arange(16)
        valid = np.ones((1, 16), bool)
        keep = np.random.default_rng(1).random((8, 16)) < 0.6
        keep[:, :2] = True
        want = rpr(rt, ru, jnp.asarray(qs), jnp.asarray(ids),
                   jnp.asarray(valid), jnp.asarray(keep))
        fn = D.make_pruned_batch_query_fn(mesh(1), k=K, n=N, c=C,
                                          block_size=64)
        assert_fields(fn(prt, pu, torch.from_numpy(qs), ids, valid,
                         torch.from_numpy(keep)), want)


def test_align_fallback():
    """Tiles that would straddle shards are refused up front: the sharded
    inner runs unpruned (`stats.fallback == "align"`)."""
    users, items = int_problem(seed=40, clusters=16)
    _, _, rt, u = ref_state("f32", users, items)
    qs = torch.from_numpy(queries(items, 4))
    pr = BK.get_backend("pruned:sharded", mesh=mesh(2))
    pr.block_size = 3 * 64                  # n % (2·192) != 0
    got = pr.query_batch(rt, u, qs, k=K, c=C)
    assert pr.stats.fallback == "align"
    assert_fields(got, BK.ShardedBackend(mesh(2)).query_batch(
        rt, u, qs, k=K, c=C))


def test_engine_sharded_end_to_end_and_rebuild(monkeypatch):
    """`build(backend="sharded")` and rebuilds go through
    `build_sharded`; a rebuild over an m off the mesh multiple falls back
    to the dense build and the index keeps answering."""
    users, items_all = map(torch.from_numpy, int_problem(seed=50, m=M + 16))
    items = items_all[:M]
    calls = []
    orig = D.build_sharded

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(D, "build_sharded", counting)
    cfg = RankTableConfig(tau=32, omega=4, s=16)
    eng = ReverseKRanksEngine.build(users, items, cfg, 3, backend="sharded",
                                    device="cpu", mesh=mesh(2))
    assert len(calls) == 1
    eng.insert_items(items_all[M:M + 16])
    eng.delete_items(list(range(8)))
    eng.rebuild()
    assert len(calls) == 2 and eng.rank_table.m == M + 8
    eng.insert_items(items_all[M + 8:M + 11])
    eng.rebuild()                                 # m = M + 11: odd
    assert len(calls) == 2 and eng._backend.build_fallback == "shape"
    qs = torch.from_numpy(queries(items.numpy(), 4))
    res = eng.query_batch(qs, K, C)
    want = ReverseKRanksEngine(eng.users, eng.rank_table, cfg,
                               backend="dense").query_batch(qs, K, C)
    assert_fields(res, want, ("indices", "R_lo_k", "R_up_k"))


def test_check_users_shape_at_append_and_compaction():
    users, items = map(torch.from_numpy, int_problem(seed=60))
    cfg = RankTableConfig(tau=32, omega=4, s=16)
    eng = ReverseKRanksEngine.build(users, items, cfg, 3, backend="sharded",
                                    device="cpu", mesh=mesh(2))
    epoch = eng.epoch
    with pytest.raises(ValueError, match="divisible by the mesh"):
        eng.upsert_users(users[:1])
    assert eng.n == N and eng.epoch == epoch      # nothing published
    eng.upsert_users(users[:2])                   # a mesh multiple: fine
    assert eng.n == N + 2
    eng.delete_users([1, 2, 3])                   # N - 1 live: odd
    rec = eng.rebuild(compact_dead_above=0.001)
    assert rec.users_compacted == 0 and eng.n == N + 2
    eng.delete_users([4])                         # N - 2 live: even
    rec = eng.rebuild(compact_dead_above=0.001)
    assert rec.users_compacted == 4 and eng.n == N - 2
    # the wrappers ask their inner backend
    for spec in ("pruned:sharded", "cached:sharded", "elastic:sharded"):
        with pytest.raises(ValueError, match="divisible"):
            BK.get_backend(spec, mesh=mesh(2)).check_users_shape(5)
    BK.get_backend("cached:dense").check_users_shape(5)


def test_cached_and_elastic_sharded_keep_the_candidate_shape():
    users, items = int_problem(seed=70)
    _, _, rt, u = ref_state("f32", users, items)
    qs = torch.from_numpy(queries(items, 4))
    want = BK.ShardedBackend(mesh(2)).query_batch(rt, u, qs, k=K, c=C)
    assert want.r_lo.shape == (4, 2 * K)
    cached = BK.get_backend("cached:sharded", mesh=mesh(2))
    for _ in range(2):                            # miss, then hits
        assert_fields(cached.query_batch(rt, u, qs, k=K, c=C), want)
    assert cached.hits == 4
    el = BK.get_backend("elastic:sharded", mesh=mesh(2))
    assert el._mode is None
    assert_fields(el.query_batch(rt, u, qs, k=K, c=C), want)
    with pytest.raises(ValueError, match="by NAME"):
        BK.get_backend(el, mesh=mesh(2))


def test_restore_onto_a_sharded_mesh():
    from repro_torch.index import IndexPersister
    users, items_all = map(torch.from_numpy, int_problem(seed=80, m=M + 8))
    cfg = RankTableConfig(tau=32, omega=4, s=16)
    eng = ReverseKRanksEngine.build(users, items_all[:M], cfg, 3,
                                    backend="sharded", device="cpu",
                                    mesh=mesh(2))
    qs = torch.from_numpy(queries(items_all.numpy(), 4))
    with tempfile.TemporaryDirectory() as d:
        eng.attach_persister(IndexPersister(d))
        eng.insert_items(items_all[M:])
        eng.delete_users([5, 6])
        got = ReverseKRanksEngine.restore(d, backend="sharded", device="cpu",
                                          mesh=mesh(2))
    assert got.mesh == mesh(2) and got.epoch == eng.epoch
    assert_fields(got.query_batch(qs, K, C), eng.query_batch(qs, K, C))


def test_auditor_width_on_candidate_set_results():
    """The auditor grades sharded results; its width follows the
    reference's rule on a (k·P,) candidate set: a mean over the selected
    users where their indices address the bounds, else no width."""
    from repro_torch.obs import QualityAuditor
    users, items = map(torch.from_numpy, int_problem(seed=90))
    cfg = RankTableConfig(tau=32, omega=4, s=16)
    eng = ReverseKRanksEngine.build(users, items, cfg, 3, backend="sharded",
                                    device="cpu", mesh=mesh(2))
    res = Q.squeeze_result(eng.query_batch(items[:1], K, C))
    aud = QualityAuditor(eng, fraction=1.0)
    try:
        assert aud.observe(items[0].numpy(), res, k=K, c=C)
        assert aud.flush(timeout=60) and aud.scored == 1
        got = res.indices.numpy()
        if res.r_lo.shape[0] >= got.max() + 1:
            want = float(np.mean((res.r_up - res.r_lo).numpy()[got]))
            assert aud.bound_width == want
        else:
            assert np.isnan(aud.bound_width)
        assert aud.accuracy == aud.accuracy        # graded
    finally:
        aud.close()


# ------------------------------------------------- the 8-device scenario
def _scenario() -> None:
    """The port at P = 8 against the reference over 8 forced host
    devices (`tests/dist/engine_dist.py`'s scenario), bitwise."""
    assert jax.device_count() == 8, jax.devices()
    users, items = int_problem(seed=100)
    n, m = users.shape[0], items.shape[0]
    rmesh = RD.flat_mesh(jax.devices())
    pmesh = D.flat_mesh(("cpu",) * 8)
    key = jax.random.PRNGKey(1)
    rcfg = RefConfig(**GRID)
    rt = RD.build_sharded(jnp.asarray(users), jnp.asarray(items), rcfg, key,
                          rmesh)
    pos, w = RT.stratified_sample_indices(key, m, rcfg)
    st = convert.from_reference(rt, users, items, pos, w, device="cpu")
    prt = D.build_sharded(st.users, st.items, RankTableConfig(**GRID),
                          st.positions, st.weights, pmesh)
    np.testing.assert_array_equal(prt.thresholds.numpy(),
                                  np.asarray(rt.thresholds))
    np.testing.assert_array_equal(prt.table.numpy(), np.asarray(rt.table))
    print("BUILD_OK")
    qs = queries(items, 8)
    for B in (1, 8):
        want = RD.make_batch_query_fn(rmesh, k=K, n=n, c=C)(
            rt, jnp.asarray(users), jnp.asarray(qs[:B]))
        got = D.make_batch_query_fn(pmesh, k=K, n=n, c=C)(
            prt, st.users, torch.from_numpy(qs[:B]))
        assert got.r_lo.shape == (B, 8 * K)
        assert_fields(got, want)
    want = RD.make_query_fn(rmesh, k=K, n=n, c=C)(rt, jnp.asarray(users),
                                                  jnp.asarray(qs[3]))
    got = D.make_query_fn(pmesh, k=K, n=n, c=C)(prt, st.users,
                                                torch.from_numpy(qs[3]))
    assert_fields(got, want)
    print("QUERY_OK")
    nb_loc, W = n // 8 // 32, 3
    rng = np.random.default_rng(2)
    ids = np.stack([rng.permutation(nb_loc)[:W] for _ in range(8)])
    ids = ids.astype(np.int32)
    valid = np.ones((8, W), bool)
    valid[:, -1] = False
    valid[5] = False
    keep = rng.random((8, n // 32)) < 0.7
    want = RD.make_pruned_batch_query_fn(rmesh, k=K, n=n, c=C,
                                         block_size=32)(
        rt, jnp.asarray(users), jnp.asarray(qs), jnp.asarray(ids),
        jnp.asarray(valid), jnp.asarray(keep))
    got = D.make_pruned_batch_query_fn(pmesh, k=K, n=n, c=C, block_size=32)(
        prt, st.users, torch.from_numpy(qs), ids, valid,
        torch.from_numpy(keep))
    assert_fields(got, want)
    print("PRUNED_OK")
    for b in (0, 5):
        want = RD.ring_exact_ranks(jnp.asarray(users), jnp.asarray(items),
                                   jnp.asarray(qs[b]), rmesh)
        got = D.ring_exact_ranks(st.users, st.items, torch.from_numpy(qs[b]),
                                 pmesh)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    print("RING_OK")
    print("ALL_OK")


def test_eight_device_scenario_against_the_reference():
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, __file__], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    for tag in ("BUILD_OK", "QUERY_OK", "PRUNED_OK", "RING_OK", "ALL_OK"):
        assert tag in out.stdout, out.stdout


# ------------------------------------------------------------- the card
@pytest.mark.cuda
def test_sharded_checks_on_card():
    """Phase 8 of chip_smoke.py at a small size on the card: the sharded
    query over 3 shards bitwise the merge of its shard bounds and with
    the dense path's R_k, the dense build fallback; the sharded build
    over 2 shards (K2 twice); pruned:sharded and the align fallback; the
    ring (4 K3 launches a query); QSRP exact and of accuracy 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import chip_smoke
    from repro_torch.core import exact as exact_mod
    from repro_torch.data.pipeline import mid_mixture, synthetic_embeddings
    dev = torch.device("cuda")
    n, m, d, n_cut = 6003, 700, 24, 5632          # 3·2001; 11·512
    users, items = synthetic_embeddings(0, n, m, d, device=dev)
    cfg = RankTableConfig(tau=32, omega=4, s=16)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    pos, w = T.stratified_sample_indices(m, cfg, g)
    qs = items[torch.arange(16, device=dev) * 7 % m].contiguous()
    eng = ReverseKRanksEngine.build(users, items, cfg, None, backend="fused",
                                    device=dev, positions=pos, weights=w)
    e8 = ReverseKRanksEngine.build(
        users, items, RankTableConfig(tau=32, omega=4, s=16,
                                      storage_dtype="int8"), None,
        backend="fused", device=dev, positions=pos, weights=w)
    truth, exact_idx, _ = chip_smoke.grade(torch, exact_mod, users, items,
                                           qs)
    mu, mi, micl = mid_mixture(5, n, m, d, device=dev)
    gm = torch.Generator(device=dev)
    gm.manual_seed(6)
    hot = mi[int(torch.nonzero(micl == 0)[0])] * 1.2
    qs_hot = (hot[None, :] * (1.0 + 1e-3 * torch.randn(
        (16, d), generator=gm, device=dev))).contiguous()
    report = chip_smoke.sharded_checks(
        dev, users=users, items=items, cfg=cfg, pos=pos, w=w, qs=qs,
        rt=eng.rank_table, int8=(e8.stored_users, e8.rank_table),
        truth=truth, exact_idx=exact_idx, mid=(mu, mi), qs_hot=qs_hot,
        n_cut=n_cut, levels=64, qsrp_block=1000)
    assert report["checks"] == list("abcde")


@pytest.mark.cuda
def test_shards_on_distinct_cards_match_shards_on_one():
    """On a machine with several cards: the sharded build, query (f32 and
    int8, static and delta), pruned query and ring over distinct cards
    are bitwise the same mesh size repeated on card 0. The shards' work
    runs on their own cards (K2 once a shard), and what crosses cards is
    the merge's order statistics and candidates."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA GPUs: shards on distinct "
                    "cards")
    from repro_torch.data.pipeline import mid_mixture
    from repro_torch.kernels import ops
    P = min(torch.cuda.device_count(), 4)
    cards = tuple(torch.device("cuda", i) for i in range(P))
    one = (torch.device("cuda", 0),) * P
    n, m, d = P * 256 * 24, 1000, 32
    users, items_all, _ = mid_mixture(3, n, m + 8, d, device=cards[0])
    items = items_all[:m].contiguous()
    qs = items[torch.arange(16, device=cards[0]) * 37 % m].contiguous()
    engines = {}
    for mesh_ in (cards, one):
        for spec in ("f32", "int8"):
            cfg = RankTableConfig(tau=64, omega=4, s=16, storage_dtype=spec)
            ops.reset_launch_counts()
            eng = ReverseKRanksEngine.build(
                users, items, cfg, 5, backend="sharded", device=cards[0],
                mesh=mesh_, cluster_reorder=True)
            assert eng._backend.build_fallback == ""
            assert ops.LAUNCHES["k2_table_build"] == P
            engines[mesh_, spec] = eng
    for spec in ("f32", "int8"):
        a, b = engines[cards, spec], engines[one, spec]
        for x, y in zip(a.rank_table, b.rank_table):
            assert (x == y) if isinstance(x, int) else (
                x is None and y is None or torch.equal(x, y))
        assert_fields(a.query_batch(qs, K, C), b.query_batch(qs, K, C))
        pa, pb = (ReverseKRanksEngine(
            e.users, e.rank_table, e.config, backend=BK.PrunedBackend(
                "sharded", mesh=mesh_, max_union_frac=1.0))
            for e, mesh_ in ((a, cards), (b, one)))
        assert_fields(pa.query_batch(qs, K, C), pb.query_batch(qs, K, C))
        assert pa._backend.stats.fallback == ""
        for e in (a, b):
            e.insert_items(items_all[m:])
            e.delete_items([3, 4])
        assert_fields(a.query_batch(qs, K, C), b.query_batch(qs, K, C))
    ring = D.ring_exact_ranks(users, items, qs[1], cards)
    assert torch.equal(ring, D.ring_exact_ranks(users, items, qs[1], one))
    from repro_torch.core.exact import exact_ranks
    assert torch.equal(ring, exact_ranks(users, items, qs[1]).to(
        torch.float32))


if __name__ == "__main__":
    torch.set_num_threads(2)
    _scenario()
