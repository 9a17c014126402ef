"""The port's elastic serving (`repro_torch.core.elastic`) and the elastic
entries of K1/K4/K5 (`kernels.ops.bound_ranks_batched_stored` with
`n_valid`) against the JAX reference, on integer inputs (every score exact in any summation order):

  * `capacity_for` and `default_tile` equal the reference's;
  * on the same converted index, elastic:dense and elastic:fused select
    as the reference's `ElasticBackend` at every spec and across an n
    sweep inside one bucket: r_lo/r_up, R_lo_k/R_up_k and the corrected
    n_accepted/n_pruned bitwise, est within 1e-5, selections equal up to
    ties of the key. The reference runs op by op (`jax.disable_jit()`,
    its dense tile unit): under `jit` XLA contracts the int8
    dequantization into one FMA (ROADMAP, port rules). Its fused inner
    is held at f32 and bf16 as well, under `jit`;
  * the delta path (a churned reference engine carried across with
    `convert.snapshot_from_reference`) likewise, and with mostly dead
    users (the pad correction's edge case);
  * the port's elastic backends are bitwise the port's own inner
    backends, every field, at c = 2.0 and 1.3;
  * `elastic_trace_count()` stays flat over an n sweep, a change of c,
    item churn on the delta path and appends + rebuild that grow n, and
    rises by exactly one when n enters a new bucket;
  * a result the caller holds is unchanged by a later call;
  * the device scalars of `query.lemma1_key` / `select_topk` and
    `rank_table.apply_delta_corrections` (c, m, m') give the bits of the
    Python-scalar path.

Left out of the reference's tests/test_elastic.py: the sharded inner
(not ported), the jit-cache scan (the port compiles nothing but its
programs) and the TPU tile-constant guard. Tests of the CUDA path carry
the `cuda` marker.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backends as RBK
from repro.core import elastic as REL
from repro.core import rank_table as R
from repro.core.engine import ReverseKRanksEngine as RefEngine
from repro.core.types import RankTableConfig as RefConfig
from repro_torch import convert
from repro_torch.core import backends as BK
from repro_torch.core import elastic as EL
from repro_torch.core import query as Q
from repro_torch.core import rank_table as T
from repro_torch.core.engine import ReverseKRanksEngine
from repro_torch.core.types import RankTable, RankTableConfig, StoredUsers
from repro_torch.kernels import ops
from repro_torch.obs import registry as obs

K, C, C_ODD = 7, 2.0, 1.3
N, M, D, B = 800, 300, 16, 4
SWEEP = (600, 643, 700, 760)            # one capacity bucket (cap 1024)
SPECS = ("f32", "bf16", "int8")
REF_SPEC = {"f32": "float32", "bf16": "bfloat16", "int8": "int8"}
INNERS = ("dense", "fused")
EST_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads, so torch does not starve the timing-sensitive
    tests that share the run."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def int_problem(seed=0, n=N, m=M, d=D):
    rng = np.random.default_rng(seed)
    return (rng.integers(-4, 5, (n, d)).astype(np.float32),
            rng.integers(-4, 5, (m, d)).astype(np.float32))


def cfgs(spec="f32"):
    kw = dict(tau=16, omega=4, s=8)
    return (RefConfig(storage_dtype=REF_SPEC[spec], **kw),
            RankTableConfig(storage_dtype=spec, **kw))


def queries(items, b=B, step=13):
    return items[(1 + np.arange(b) * step) % items.shape[0]]


@pytest.fixture(scope="module", params=SPECS)
def index(request):
    """A reference index at one spec and the same index in the port."""
    spec = request.param
    users, items = int_problem()
    rcfg, pcfg = cfgs(spec)
    rt = R.build_rank_table(jnp.asarray(users), jnp.asarray(items), rcfg,
                            jax.random.PRNGKey(1))
    packed = rcfg.storage.pack_users(jnp.asarray(users))
    st = convert.from_reference(rt, users, stored_users=packed,
                                device="cpu")
    return dict(spec=spec, users=users, items=items, rcfg=rcfg, pcfg=pcfg,
                rt=rt, packed=packed, prt=st.rank_table, pusers=st.users,
                pstored=st.stored_users)


def _rows(index, n):
    """(reference users, reference table, port users, port table) of the
    first n rows, the users in spec space."""
    idx = jnp.arange(n)
    ru = (jnp.asarray(index["users"][:n]) if index["packed"] is None
          else index["packed"].take_rows(idx))
    pu = (index["pusers"][:n] if index["pstored"] is None
          else index["pstored"].take_rows(torch.arange(n)))
    return ru, index["rt"].take_rows(idx), pu, \
        index["prt"].take_rows(torch.arange(n))


def assert_like_reference(got, want, k=K):
    """Bounds, order statistics and counters bitwise; est within 1e-5 on
    the users both select; selections equal up to ties of the key."""
    for f in ("r_lo", "r_up", "R_lo_k", "R_up_k", "guaranteed",
              "n_accepted", "n_pruned"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    g_idx, w_idx = got.indices.numpy(), np.asarray(want.indices)
    g_est, w_est = got.est_rank.numpy(), np.asarray(want.est_rank)
    for b in range(g_idx.shape[0]):
        both = np.intersect1d(g_idx[b], w_idx[b])
        ge = dict(zip(g_idx[b], g_est[b]))
        we = dict(zip(w_idx[b], w_est[b]))
        for u in both:
            np.testing.assert_allclose(ge[u], we[u], rtol=EST_RTOL)
        # a user chosen by one side only ties the other's k-th estimate
        for u in set(g_idx[b].tolist()) ^ set(w_idx[b].tolist()):
            kth = max(g_est[b].max(), w_est[b].max())
            assert (ge.get(u, we.get(u))) <= kth * (1 + EST_RTOL), (b, u)


def assert_bitwise(got, want):
    for f in want._fields:
        x, y = getattr(got, f), getattr(want, f)
        assert x.shape == y.shape and torch.equal(x, y), f


# ------------------------------------------------------------ the knobs
def test_capacity_for_matches_the_reference():
    for tile in (32, 64, 256):
        for n in (1, 31, 32, 33, 255, 256, 257, 600, 1024, 1025, 100_000,
                  480_189):
            assert EL.capacity_for(n, tile) == REL.capacity_for(n, tile)
    assert EL.capacity_for(480_189, 256) == 524_288


def test_tile_knob_validation(monkeypatch):
    with pytest.raises(ValueError, match="multiple of 32"):
        EL.ElasticBackend("dense", tile=33)
    for raw, ok in (("64", True), ("20", False), ("", True), ("96", True)):
        monkeypatch.setenv("REPRO_ELASTIC_TILE", raw)
        if ok:
            assert EL.default_tile() == REL.default_tile()
        else:
            for mod in (EL, REL):
                with pytest.raises(ValueError, match="multiple of 32"):
                    mod.default_tile()


# ----------------------------------------------- against the reference
@pytest.mark.parametrize("inner", INNERS)
def test_elastic_matches_the_reference_across_n(index, inner):
    qs = queries(index["items"])
    ref_el = RBK.get_backend("elastic:dense")
    ref_fused = RBK.get_backend("elastic:fused")
    port = BK.get_backend(f"elastic:{inner}")
    assert port.name == f"elastic:{inner}"
    for n in SWEEP:
        ru, rrt, pu, prt = _rows(index, n)
        got = port.query_batch(prt, pu, torch.from_numpy(qs), k=K, c=C)
        assert got.r_lo.shape == (B, n)
        with jax.disable_jit():
            want = ref_el.query_batch(rrt, ru, jnp.asarray(qs), k=K, c=C)
        assert_like_reference(got, want)
        if inner == "fused" and index["spec"] != "int8" and n == SWEEP[1]:
            assert_like_reference(got, ref_fused.query_batch(
                rrt, ru, jnp.asarray(qs), k=K, c=C))


@pytest.mark.parametrize("c", [C, C_ODD, 1e6])
def test_elastic_is_bitwise_the_inner(index, c):
    qs = torch.from_numpy(queries(index["items"], 5))
    for inner in INNERS:
        el, base = BK.get_backend(f"elastic:{inner}"), BK.get_backend(inner)
        for n in (SWEEP[0], SWEEP[-1]):
            _, _, pu, prt = _rows(index, n)
            assert_bitwise(el.query_batch(prt, pu, qs, k=K, c=c),
                           base.query_batch(prt, pu, qs, k=K, c=c))
        # k = n: the selection spans every real row
        assert_bitwise(el.query_batch(prt, pu, qs, k=n, c=c),
                       base.query_batch(prt, pu, qs, k=n, c=c))


def test_k_past_n_delegates_to_the_inner(index):
    _, _, pu, prt = _rows(index, 40)
    qs = torch.from_numpy(queries(index["items"]))
    el, base = EL.ElasticBackend("dense"), BK.get_backend("dense")
    before = EL.elastic_trace_count()

    def probe(bk):
        try:
            return "ok", bk.query_batch(prt, pu, qs, k=41, c=C)
        except Exception as e:                      # noqa: BLE001
            return "err", type(e)

    (kind_e, val_e), (kind_b, val_b) = probe(el), probe(base)
    assert kind_e == kind_b and EL.elastic_trace_count() == before
    if kind_b == "ok":
        assert_bitwise(val_e, val_b)
    else:
        assert val_e is val_b


@pytest.fixture(scope="module", params=("f32", "int8"))
def churned(request):
    """A churned reference engine (items in and out, users deleted) and
    its current snapshot in the port."""
    spec = request.param
    users, items = int_problem()
    rcfg, _ = cfgs(spec)
    key = jax.random.PRNGKey(1)
    eng = RefEngine.build(jnp.asarray(users), jnp.asarray(items), rcfg, key)
    rng = np.random.default_rng(11)
    eng.insert_items(jnp.asarray(rng.integers(-4, 5, (16, D)).astype(
        np.float32)))
    eng.delete_items(list(range(5, 15)))
    eng.delete_users(list(range(0, 30, 3)))
    rs = eng.current_snapshot()
    art = R.sampling_artifacts(jnp.asarray(items), rcfg, key)
    return dict(spec=spec, ref=rs, port=convert.snapshot_from_reference(
        rs, art, device="cpu"), items=items)


@pytest.mark.parametrize("inner", INNERS)
def test_delta_path_matches_the_reference(churned, inner):
    rs, ps = churned["ref"], churned["port"]
    qs = queries(churned["items"])
    got = BK.get_backend(f"elastic:{inner}").query_batch(
        ps.rank_table, ps.query_users(), torch.from_numpy(qs), k=K, c=C,
        delta=ps.corr)
    with jax.disable_jit():
        want = RBK.get_backend("elastic:dense").query_batch(
            rs.rank_table, rs.query_users(), jnp.asarray(qs), k=K, c=C,
            delta=rs.corr)
    assert_like_reference(got, want)
    assert_bitwise(got, BK.get_backend(inner).query_batch(
        ps.rank_table, ps.query_users(), torch.from_numpy(qs), k=K, c=C,
        delta=ps.corr))


def test_delta_mostly_dead_users():
    """k past the LIVE user count drives R↑_k to +inf: the pad
    correction's edge case (+inf ≤ c·inf counts the pads accepted, inf >
    inf none pruned, as the unpadded program counts its dead rows)."""
    users, items = int_problem()
    rcfg, pcfg = cfgs()
    key = jax.random.PRNGKey(1)
    dead = [i for i in range(N) if i % 160 != 0]            # 5 live
    reng = RefEngine.build(jnp.asarray(users), jnp.asarray(items), rcfg, key)
    reng.delete_users(dead)
    pos, w = R.stratified_sample_indices(key, M, rcfg)
    st = convert.from_reference(reng.rank_table, users, items, pos, w,
                                device="cpu")
    qs = queries(items)
    res = {}
    for backend in ("elastic:dense", "elastic:fused", "dense"):
        eng = ReverseKRanksEngine(st.users, st.rank_table, pcfg,
                                  backend=backend, items=st.items,
                                  positions=st.positions, weights=st.weights)
        eng.delete_users(dead)
        res[backend] = eng.query_batch(torch.from_numpy(qs), K, C)
    assert bool(torch.isinf(res["dense"].R_up_k).all())
    assert_bitwise(res["elastic:dense"], res["dense"])
    assert_bitwise(res["elastic:fused"], res["dense"])
    with jax.disable_jit():
        want = RBK.get_backend("elastic:dense").query_batch(
            reng.rank_table, jnp.asarray(users), jnp.asarray(qs), k=K, c=C,
            delta=reng.current_snapshot().corr)
    assert_like_reference(res["elastic:dense"], want)


# ------------------------------------------------------- compile-once
def _engine(backend, n=600, spec="f32"):
    users, items = int_problem()
    _, pcfg = cfgs(spec)
    eng = ReverseKRanksEngine.build(torch.from_numpy(users[:n]),
                                    torch.from_numpy(items), pcfg, 0,
                                    backend=backend, device="cpu")
    return eng, users, items


@pytest.mark.parametrize("inner", INNERS)
def test_trace_count_flat_across_serving_changes(inner):
    """After warm-up: an n sweep inside the bucket, a change of c, item
    churn on the delta path, and appends + rebuild growing n build no
    program; n entering a new bucket builds exactly one."""
    eng, users, items = _engine(f"elastic:{inner}")
    bk = eng._backend
    qs = torch.from_numpy(queries(items))
    eng.query_batch(qs, K, C)                           # warm-up
    t0 = EL.elastic_trace_count()
    rt, pu = eng.rank_table, eng.users
    for n in (520, 550, 600):                           # cap 1024 each
        got = bk.query_batch(rt.take_rows(torch.arange(n)), pu[:n], qs, k=K,
                             c=C)
        assert_bitwise(got, BK.get_backend(inner).query_batch(
            rt.take_rows(torch.arange(n)), pu[:n], qs, k=K, c=C))
    eng.query_batch(qs, K, C_ODD)
    assert EL.elastic_trace_count() == t0
    extra = torch.from_numpy(items[:8] * 2)
    eng.insert_items(extra[:3])
    eng.delete_items([0, 1, 2])
    eng.query_batch(qs, K, C)                           # delta warm-up
    t1 = EL.elastic_trace_count()
    assert t1 == t0 + 1
    eng.insert_items(extra[3:6])
    eng.delete_items([3, 4, 5])
    eng.query_batch(qs, K, C_ODD)
    eng.upsert_users(torch.from_numpy(users[600:700]))  # n = 700
    eng.query_batch(qs, K, C)
    assert EL.elastic_trace_count() == t1
    for grow in (43, 17):
        eng.upsert_users(torch.from_numpy(users[eng.n:eng.n + grow]))
        assert eng.rebuild() is not None
        eng.query_batch(qs, K, C)
    assert eng.n == 760 and eng.rank_table.m == M
    assert EL.elastic_trace_count() == t1               # m unchanged
    eng.upsert_users(torch.from_numpy(users[760:N]) + 1)  # n = 800
    eng.query_batch(qs, K, C)
    assert EL.elastic_trace_count() == t1
    small = 300                                         # a new bucket
    bk.query_batch(eng.rank_table.take_rows(torch.arange(small)),
                   eng.users[:small], qs, k=K, c=C)
    assert EL.elastic_trace_count() == t1 + 1


def test_hot_swap_results_follow_the_index():
    """Rebuilds that grow n republish into the same program, with the
    results of a fresh dense engine over the same index at every step."""
    eng, users, items = _engine("elastic:fused")
    qs = torch.from_numpy(queries(items))
    eng.query_batch(qs, K, C)
    t0 = EL.elastic_trace_count()
    for grow in (43, 57, 60):
        eng.upsert_users(torch.from_numpy(users[eng.n:eng.n + grow]))
        assert eng.rebuild() is not None
        dense = ReverseKRanksEngine(eng.users, eng.rank_table, eng.config,
                                    backend="dense")
        assert_bitwise(eng.query_batch(qs, K, C), dense.query_batch(qs, K, C))
    assert eng.n == 760 and EL.elastic_trace_count() == t0


def test_held_result_is_unchanged_by_a_later_call():
    eng, users, items = _engine("elastic:fused")
    a = eng.query_batch(torch.from_numpy(queries(items)), K, C)
    held = [x.clone() for x in a]
    eng.query_batch(torch.from_numpy(queries(items, step=5) + 1), K, C_ODD)
    eng.upsert_users(torch.from_numpy(users[600:650]))
    eng.query_batch(torch.from_numpy(queries(items)[::-1].copy()), K, C)
    for x, y in zip(a, held):
        assert torch.equal(x, y)


def test_repads_once_per_generation_and_resets_pad_rows():
    users, items = int_problem()
    _, pcfg = cfgs("int8")
    eng = ReverseKRanksEngine.build(torch.from_numpy(users),
                                    torch.from_numpy(items), pcfg, 0,
                                    backend="dense", device="cpu")
    rt, su = eng.rank_table, eng.stored_users
    el = EL.ElasticBackend("dense")
    qs = torch.from_numpy(queries(items))
    repads = obs.get_default().counter("elastic_repads_total")
    r0 = repads.value
    u_n = su.take_rows(torch.arange(760))   # one generation: one repad
    rt_n = rt.take_rows(torch.arange(760))
    for c in (C, C_ODD, C):
        el.query_batch(rt_n, u_n, qs, k=K, c=c)
    assert repads.value == r0 + 1
    bucket, = el._buckets.values()
    n = 600                                 # shrink: rows 600..759 reset
    el.query_batch(rt.take_rows(torch.arange(n)),
                   su.take_rows(torch.arange(n)), qs, k=K, c=C)
    assert repads.value == r0 + 2 and len(el._buckets) == 1
    assert bucket.filled == n
    fresh = EL._Bucket(rt.take_rows(torch.arange(n)),
                       su.take_rows(torch.arange(n)), None, bucket.cap)
    for a, b in zip(bucket.rt, fresh.rt):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    for a, b in zip(bucket.users, fresh.users):
        assert torch.equal(a, b)


def test_pad_conventions_match_the_reference():
    users, items = int_problem(n=300)
    for spec in SPECS:
        rcfg, _ = cfgs(spec)
        rt = R.build_rank_table(jnp.asarray(users), jnp.asarray(items), rcfg,
                                jax.random.PRNGKey(1))
        packed = rcfg.storage.pack_users(jnp.asarray(users))
        st = convert.from_reference(rt, users, stored_users=packed,
                                    device="cpu")
        want_rt = REL._pad_table(rt, 512)
        got_rt = EL._pad_table(st.rank_table, 512)
        for f in RankTable._fields:
            if f == "m":
                continue
            w, g = getattr(want_rt, f), getattr(got_rt, f)
            assert (w is None) == (g is None), f
            if g is not None:
                np.testing.assert_array_equal(
                    g.float().numpy(), np.asarray(w).astype(np.float32), f)
        pu = st.users if packed is None else st.stored_users
        want_u = REL._pad_users(jnp.asarray(users) if packed is None
                                else packed, 512)
        got_u = EL._pad_users(pu, 512)
        if packed is None:
            np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))
        else:
            for g, w in zip(got_u, want_u):
                assert (g is None) == (w is None)
                if g is not None:
                    np.testing.assert_array_equal(
                        g.float().numpy(), np.asarray(w).astype(np.float32))


def test_registry_and_delegation():
    assert BK.get_backend("elastic:").name == "elastic:dense"
    with pytest.raises(ValueError, match="unknown query backend"):
        BK.get_backend("elastic")
    with pytest.raises(ValueError, match="unknown query backend"):
        BK.get_backend("elastic:no-such-backend")
    eng, users, items = _engine("dense")
    qs = torch.from_numpy(queries(items))
    el = BK.get_backend("elastic:pruned:dense")
    assert el._mode is None and el.name == "elastic:pruned:dense"
    before = EL.elastic_trace_count()
    want = BK.get_backend("pruned:dense").query_batch(
        eng.rank_table, eng.users, qs, k=K, c=C)
    assert_bitwise(el.query_batch(eng.rank_table, eng.users, qs, k=K, c=C),
                   want)
    assert EL.elastic_trace_count() == before

    class Subclassed(BK.DenseBackend):
        def bound_ranks(self, rt, users, qs):
            return super().bound_ranks(rt, users, qs)

    assert EL.ElasticBackend(Subclassed())._mode is None


# ------------------------------------------------------ device scalars
def test_selection_takes_device_scalars_bitwise():
    rng = np.random.default_rng(3)
    r_lo = torch.from_numpy(rng.integers(1, 300, (5, 200)).astype(np.float32))
    r_up = r_lo + torch.from_numpy(rng.integers(0, 40, (5, 200)).astype(
        np.float32))
    est = r_lo + 0.37 * (r_up - r_lo)
    for c in (C, C_ODD, 1.1):
        for m in (299, 301):
            want = Q.select_topk(r_lo, r_up, est, k=K, c=c, m_items=m)
            got = Q.select_topk(r_lo, r_up, est, k=K,
                                c=torch.tensor(c, dtype=torch.float32),
                                m_items=torch.tensor(float(m)))
            assert_bitwise(got, want)


def test_lookup_takes_a_device_m_bitwise(index):
    _, _, pu, prt = _rows(index, 300)
    qs = torch.from_numpy(queries(index["items"], 6))
    want = Q.bound_ranks_batch(prt, pu, qs)
    got = Q.bound_ranks_batch(prt._replace(m=torch.tensor(float(prt.m))),
                              pu, qs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_delta_correction_takes_a_device_m_new_bitwise(churned):
    ps = churned["port"]
    corr = ps.corr._replace(m_new=ps.corr.m_new + 1)    # odd and even m'
    qs = torch.from_numpy(queries(churned["items"]))
    for cr in (ps.corr, corr):
        want = Q._delta_bounds_batch(ps.rank_table, ps.query_users(), qs, cr)
        got = Q._delta_bounds_batch(
            ps.rank_table, ps.query_users(), qs,
            cr._replace(m_new=torch.tensor(float(cr.m_new))))
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert {ps.corr.m_new % 2, corr.m_new % 2} == {0, 1}


# ------------------------------------------------ the elastic entries
@pytest.mark.parametrize("B_", [1, 16, 19])
def test_elastic_entry_plain_version(index, B_):
    """`ops.bound_ranks_batched_stored(..., n_valid)` on CPU tensors (its plain version): rows
    below n_valid bitwise the existing wrapper over those rows, rows past
    it m + 2; no launch counted."""
    cap = EL.capacity_for(700, 256)
    users = index["pusers"] if index["pstored"] is None else \
        index["pstored"]
    prt = index["prt"]
    qs = torch.from_numpy(queries(index["items"], B_))
    before = dict(ops.LAUNCHES)
    for nv in (1, 255, 257, 700, cap):
        nv = min(nv, N)
        rt_p = EL._pad_table(prt, cap)
        got = ops.bound_ranks_batched_stored(
            EL._pad_users(users, cap), qs, rt_p,
            torch.tensor([nv], dtype=torch.int32))
        idx = torch.arange(nv)
        u_n = users.take_rows(idx) if isinstance(users, StoredUsers) \
            else users[:nv]
        want = ops.bound_ranks_batched_stored(u_n, qs, prt.take_rows(idx))
        for g, w in zip(got, want):
            assert g.shape == (B_, cap)
            assert torch.equal(g[:, :nv], w)
            assert bool((g[:, nv:] == float(prt.m + 2)).all())
    assert dict(ops.LAUNCHES) == before


def test_elastic_entry_rejects_malformed_count():
    users, items = int_problem(n=64)
    rt = RankTable(torch.zeros(64, 4), torch.ones(64, 4), 10)
    u = torch.from_numpy(users)
    qs = torch.from_numpy(items[:2])
    for bad in (torch.tensor([3], dtype=torch.int64),
                torch.tensor([3, 4], dtype=torch.int32),
                torch.tensor(3, dtype=torch.int32)):
        with pytest.raises((TypeError, ValueError)):
            ops.bound_ranks_batched_stored(u, qs, rt, bad)


# ----------------------------------------------------------- on the card
@pytest.mark.cuda
def test_elastic_entries_at_their_edges_on_card():
    """chip_smoke.py's phase-3 check of the elastic entries of K1, K4 and
    K5 (every kind, B in 1, 16, 19, n_valid in 1, T - 1, T + 1, n,
    capacity): rows below n_valid bitwise the existing entry and the
    plain version's bounds, rows past it unwritten. On a GPU machine:
    PYTHONPATH=src:. python -m pytest -m cuda tests/test_torch_elastic.py"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import chip_smoke
    lines = chip_smoke.elastic_entry_checks(torch.device("cuda"))
    assert len(lines) == 3


@pytest.mark.cuda
def test_serving_checks_on_card():
    """Phase 6 of chip_smoke.py at a small size on the card: the elastic
    programs captured into CUDA graphs and replayed bitwise the fused
    engine at every spec, no new capture across an n sweep, a change of
    c, churn and a rebuild, and MicroBatcher results at pipeline depth 2
    bitwise the synchronous ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import chip_smoke
    from repro_torch.data.pipeline import synthetic_embeddings
    dev = torch.device("cuda")
    n, m, d = 60_000, 700, 24
    users, items = synthetic_embeddings(0, n, m, d, device=dev)
    cfg = RankTableConfig(tau=32, omega=4, s=16)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    pos, w = T.stratified_sample_indices(m, cfg, g)
    engines = {spec: ReverseKRanksEngine.build(
        users, items, RankTableConfig(tau=32, omega=4, s=16,
                                      storage_dtype=spec), None,
        backend="fused", device=dev, positions=pos, weights=w)
        for spec in SPECS}
    qs = items[torch.arange(16, device=dev) * 7 % m].contiguous()
    report = chip_smoke.serving_checks(
        dev, users=users, items=items, cfg=cfg, pos=pos, w=w, qs=qs,
        engines=engines, sweep=(50_000, 55_000, 60_000), n_serve=128,
        timing=False)
    assert report["checks"] == list("abcdefg")
