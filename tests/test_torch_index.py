"""The port's mutable index (`repro_torch.index`, the engine's mutation
API, the delta paths of every backend) against the JAX reference, one
stage at a time, each stage fed the reference's own state carried across
by `repro_torch.convert`:

  pack      `StorageSpec.pack_scores`, `RankTable.set_rows/append_rows`
            bitwise, and out of place;
  buffer    `build_correction` on the reference's delta state, bitwise at
            every spec; `DeltaState` after the same mutations;
  counts    `apply_delta_corrections` (and the count ranges) on the
            reference's correction, scores and slack: bitwise the
            reference run op by op at every spec and the jitted one at
            f32 and bf16; at int8 every cell that differs from the jitted
            reference holds the value of XLA's contraction of
            s ∓ slack ∓ (½ + pad)·scale into one fused multiply-add;
  engine    one mutation sequence on a reference engine and on a port
            engine that starts from the reference's table, positions and
            weights: the same delta state and correction, untouched rows
            bitwise and upserted rows to the reference's own tolerance
            (rtol 1e-6), bounds bitwise on untouched live rows (f32,
            bf16; int8 up to the contraction), selections equal up to
            ties at B ∈ {1, 16} on dense, fused, pruned:dense and
            pruned:fused;
  rebuild   insert → delete → rebuild equal to a build from scratch over
            the live items, bitwise (same seed; and the reference's
            positions), mid-build mutations re-based, remap lineages.

Inputs are integer-valued where bits matter: every score is then exact
in any summation order, so the two packages see the same scores. Tests
of the CUDA path carry the `cuda` marker.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.engine import ReverseKRanksEngine as RefEngine
from repro.core.query import user_scores_batch as ref_user_scores_batch
from repro.core.query import select_topk as ref_select_topk
from repro.core import rank_table as R
from repro.core.types import DeltaCorrection as RefCorrection
from repro.core.types import RankTableConfig as RefConfig
from repro.index import delta as RD
from repro.index.snapshot import compose_remaps as ref_compose_remaps
from repro_torch import convert
from repro_torch.core import query as Q
from repro_torch.core import rank_table as T
from repro_torch.core.backends import PrunedBackend, get_backend
from repro_torch.core.engine import ReverseKRanksEngine
from repro_torch.core.types import DeltaCorrection, RankTableConfig, \
    StorageSpec
from repro_torch.index import delta as D
from repro_torch.index.snapshot import compose_remaps

K, C = 7, 2.0
N, M, DIM, EXTRA = 512, 400, 16, 16
SPECS = ("f32", "bf16", "int8")
REF_SPEC = {"f32": "float32", "bf16": "bfloat16", "int8": "int8"}
BACKENDS = ("dense", "fused", "pruned:dense", "pruned:fused")
EST_RTOL = 1e-5
HALF = np.float32(0.5 + 1e-4)          # the int8 count's ½ + pad, in f32


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads, so torch does not starve the timing-sensitive
    tests that share the run."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def int_problem(seed=0, n=N, m=M + EXTRA, d=DIM):
    """Integer users (n, d) and items (m, d), from numpy."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-4, 5, (n, d)).astype(np.float32),
            rng.integers(-4, 5, (m, d)).astype(np.float32))


def cfgs(spec="f32", **kw):
    kw = dict(tau=16, omega=4, s=8, **kw)
    return (RefConfig(storage_dtype=REF_SPEC[spec], **kw),
            RankTableConfig(storage_dtype=spec, **kw))


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.to(torch.float32) if t.dtype == torch.bfloat16 else t
        return t.numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


CHURN_RNG = 5


def churn_vectors():
    """The vectors of the scripted mutation sequence, integer-valued."""
    rng = np.random.default_rng(CHURN_RNG)
    return (rng.integers(-4, 5, (2, DIM)).astype(np.float32),
            rng.integers(-4, 5, (2, DIM)).astype(np.float32))


def churn(eng, new_items, as_tensor):
    """Inserts, base and fresh-item deletions, an upsert of two rows, an
    append of two users, two user deletions (one of them appended)."""
    up, app = (as_tensor(v) for v in churn_vectors())
    ids = eng.insert_items(as_tensor(new_items))
    eng.delete_items([3, 17, int(ids[1])])
    eng.upsert_users(up, indices=[5, 40])
    eng.upsert_users(app)
    eng.delete_users([9, N + 1])
    return ids


TOUCHED = (5, 40, N, N + 1)


# ------------------------------------------------------------------ pack
@pytest.mark.parametrize("pad", [0, 3])
@pytest.mark.parametrize("spec", SPECS)
def test_pack_scores_is_bitwise_the_reference(spec, pad):
    rng = np.random.default_rng(1)
    scores = np.sort(rng.normal(size=(40, 9)).astype(np.float32) * 5, 1)
    want = RefConfig(storage_dtype=REF_SPEC[spec]).storage.pack_scores(
        jnp.asarray(scores), pad)
    got = StorageSpec(spec).pack_scores(torch.from_numpy(scores), pad)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(_np(g), _np(w))
    assert got[0].shape == (40, 9 + pad)
    assert got[0].dtype == StorageSpec(spec).table_dtype


@pytest.mark.parametrize("spec", SPECS)
def test_set_and_append_rows_are_out_of_place(spec):
    """Scattered and appended rows equal the reference's; the table they
    came from keeps every tensor unchanged (an older snapshot still reads
    it, and the pruned backend keys summaries on its identity)."""
    rng = np.random.default_rng(2)
    thr = np.sort(rng.normal(size=(30, 8)).astype(np.float32), 1)
    tab = np.sort(rng.uniform(1, 50, (30, 8)).astype(np.float32), 1)[:, ::-1]
    rthr = np.sort(rng.normal(size=(3, 8)).astype(np.float32), 1)
    rtab = np.sort(rng.uniform(1, 50, (3, 8)).astype(np.float32), 1)[:, ::-1]
    rspec = RefConfig(storage_dtype=REF_SPEC[spec]).storage
    ref_rt = rspec.pack_table(jnp.asarray(thr), jnp.asarray(tab.copy()))
    ref_rows = rspec.pack_table(jnp.asarray(rthr), jnp.asarray(rtab.copy()))
    rt, rows = (convert.from_reference(x, device="cpu").rank_table
                for x in (ref_rt, ref_rows))
    before = [None if x is None or isinstance(x, int) else x.clone()
              for x in rt]
    idx = np.asarray([4, 0, 29])
    for got, want in ((rt.set_rows(torch.from_numpy(idx), rows),
                       ref_rt.set_rows(jnp.asarray(idx), ref_rows)),
                      (rt.append_rows(rows), ref_rt.append_rows(ref_rows))):
        for f in rt._fields:
            if f == "m":
                continue
            g, w = getattr(got, f), getattr(want, f)
            assert (g is None) == (w is None), f
            if g is not None:
                np.testing.assert_array_equal(_np(g), _np(w), f)
    for old, x in zip(before, rt):
        if old is not None:
            assert torch.equal(old, x)


# ---------------------------------------------------------------- buffer
@pytest.fixture(scope="module", params=SPECS)
def mutated(request):
    """One mutation sequence on a reference engine and on a port engine
    that starts from the reference's table, positions and weights."""
    spec = request.param
    users, items_all = int_problem()
    items, new = items_all[:M], items_all[M:]
    rcfg, pcfg = cfgs(spec)
    key = jax.random.PRNGKey(1)
    ref = RefEngine.build(jnp.asarray(users), jnp.asarray(items), rcfg, key)
    pos, w = R.stratified_sample_indices(key, M, rcfg)
    st = convert.from_reference(ref.rank_table, users, items, pos, w,
                                device="cpu")
    port = ReverseKRanksEngine(st.users, st.rank_table, pcfg, items=st.items,
                               positions=st.positions, weights=st.weights)
    churn(ref, new, jnp.asarray)
    churn(port, new, torch.from_numpy)
    qs = {B: items[(1 + np.arange(B) * 13) % M] for B in (1, 16)}
    with jax.disable_jit():     # the reference's arithmetic as written
        ref_res = {B: ref.query_batch(jnp.asarray(q), K, C)
                   for B, q in qs.items()}
    return dict(spec=spec, ref=ref, port=port, qs=qs, ref_res=ref_res,
                users=users, items=items, new=new, key=key, pos=pos, w=w,
                rcfg=rcfg, pcfg=pcfg)


def test_delta_state_matches_the_reference(mutated):
    rs, ps = (e.current_snapshot() for e in (mutated["ref"],
                                             mutated["port"]))
    assert ps.epoch == rs.epoch == 5
    for f in ("base_live", "added_ids", "user_live"):
        np.testing.assert_array_equal(getattr(ps.delta, f),
                                      np.asarray(getattr(rs.delta, f)), f)
    assert ps.delta.touched_users == rs.delta.touched_users == set(TOUCHED)
    np.testing.assert_array_equal(_np(ps.delta.added_items),
                                  _np(rs.delta.added_items))
    np.testing.assert_array_equal(mutated["port"].live_item_ids(),
                                  mutated["ref"].live_item_ids())
    np.testing.assert_array_equal(_np(mutated["port"].live_items()),
                                  _np(mutated["ref"].live_items()))
    assert str(mutated["port"].delta_stats()) == str(
        mutated["ref"].delta_stats())
    assert ps.m_live == rs.m_live == M + EXTRA - 1 - 2


def test_correction_matches_the_reference(mutated):
    """The port's correction (its own `build_correction`) and the one
    built from the reference's converted delta state are bitwise the
    reference's."""
    rs, ps = (e.current_snapshot() for e in (mutated["ref"],
                                             mutated["port"]))
    want = convert.correction_from_reference(rs.corr, device="cpu")
    again = D.build_correction(
        ps.users, ps.base,
        convert.delta_state_from_reference(rs.delta, device="cpu"),
        M, spec=mutated["pcfg"].storage)
    for got in (ps.corr, again):
        assert got.m_new == want.m_new and got.selection_m() == int(
            rs.corr.selection_m())
        assert (got.n_add, got.n_del) == (16, 8)
        for f in DeltaCorrection._fields:
            g, w = getattr(got, f), getattr(want, f)
            if f == "m_new":
                continue
            assert (g is None) == (w is None), f
            if g is not None:
                assert g.dtype == w.dtype, f
                assert torch.equal(g, w), f


def test_sampling_state_matches_the_reference(mutated):
    """The norm order, sampled ids and samples of the port's base equal
    the reference's `sampling_artifacts` / `BaseIndex`."""
    rs, ps = (e.current_snapshot() for e in (mutated["ref"],
                                             mutated["port"]))
    art = R.sampling_artifacts(jnp.asarray(mutated["items"]),
                               mutated["rcfg"], mutated["key"])
    np.testing.assert_array_equal(ps.base.order.numpy(),
                                  np.asarray(art.order))
    np.testing.assert_array_equal(ps.base.positions.numpy(),
                                  np.asarray(art.positions))
    np.testing.assert_array_equal(ps.base.sample_ids, rs.base.sample_ids)
    np.testing.assert_array_equal(_np(ps.base.samples),
                                  _np(rs.base.samples))
    np.testing.assert_array_equal(ps.base.weights_host,
                                  rs.base.weights_host)
    conv = convert.base_from_reference(rs.base, art, device="cpu")
    for f in ("items", "samples", "weights", "positions", "order"):
        assert torch.equal(getattr(conv, f), getattr(ps.base, f)), f
    np.testing.assert_array_equal(conv.sample_ids, ps.base.sample_ids)


def test_snapshot_converts_whole(mutated):
    rs, ps = (e.current_snapshot() for e in (mutated["ref"],
                                             mutated["port"]))
    art = R.sampling_artifacts(jnp.asarray(mutated["items"]),
                               mutated["rcfg"], mutated["key"])
    cs = convert.snapshot_from_reference(rs, art, device="cpu")
    assert cs.epoch == rs.epoch and cs.config.storage == mutated[
        "pcfg"].storage and cs.config.tau == mutated["pcfg"].tau
    assert cs.n == ps.n and cs.m_live == ps.m_live
    assert torch.equal(cs.users, ps.users)
    np.testing.assert_array_equal(cs.delta.user_live, ps.delta.user_live)
    np.testing.assert_array_equal(cs.live_item_ids(), ps.live_item_ids())
    for f in ("add_scores", "del_scores", "user_live"):
        assert torch.equal(getattr(cs.corr, f), getattr(ps.corr, f))


def test_table_rows_match_the_reference(mutated):
    """Untouched rows bitwise (both carry the base table); the upserted
    and appended rows, which each package re-estimates, bitwise the
    reference's `recompute_user_rows` run op by op, and within a
    rounding of each row's largest threshold of the jitted one (XLA
    contracts the threshold grid's multiply-add)."""
    rs, ps = (e.current_snapshot() for e in (mutated["ref"],
                                             mutated["port"]))
    want = convert.from_reference(rs.rank_table, device="cpu").rank_table
    got = ps.rank_table
    assert got.n == N + 2 and got.m == M
    mask = np.ones(N + 2, bool)
    mask[list(TOUCHED)] = False
    for f in got._fields:
        g, w = getattr(got, f), getattr(want, f)
        if f == "m" or g is None:
            continue
        np.testing.assert_array_equal(_np(g)[mask], _np(w)[mask], f)
    vecs = np.asarray(rs.users)[list(TOUCHED)]
    with jax.disable_jit():
        thr, tab = R.recompute_user_rows(
            jnp.asarray(vecs), rs.base.samples, rs.base.weights,
            mutated["rcfg"], max_norm=rs.base.max_norm)
    f32 = mutated["port"]._user_rows(ps.users, torch.tensor(TOUCHED),
                                     ps.base)
    np.testing.assert_array_equal(f32[0].numpy(), np.asarray(thr))
    np.testing.assert_array_equal(f32[1].numpy(), np.asarray(tab))
    packed = mutated["pcfg"].storage.pack_table(*f32)
    for f in got._fields:
        if f != "m" and getattr(got, f) is not None:
            assert torch.equal(getattr(got, f)[list(TOUCHED)],
                               getattr(packed, f)), f
    if mutated["spec"] == "f32":
        g, w = got.thresholds.numpy(), want.thresholds.numpy()
        scale = np.abs(w).max(axis=1, keepdims=True)
        assert np.all(np.abs(g - w) <= 2.0 ** -22 * scale)
        np.testing.assert_allclose(got.table.numpy(), want.table.numpy(),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("backend", BACKENDS)
def test_delta_queries_match_the_reference(mutated, backend, B):
    """Every port backend on the port's mutated snapshot against the
    reference engine's dense delta query run op by op: bounds bitwise on
    every live row (the upserted ones included) at every spec, dead rows
    +inf, est to 1e-5, and the selection equal up to ties of the key
    (`test_apply_delta_corrections_against_the_reference` holds the
    correction against the jitted reference too)."""
    ps = mutated["port"].current_snapshot()
    qs = torch.from_numpy(mutated["qs"][B])
    bk = get_backend(backend) if not backend.startswith("pruned") else \
        PrunedBackend(backend.split(":")[1], block_size=64,
                      max_union_frac=1.0)
    got = bk.query_batch(ps.rank_table, ps.query_users(), qs, k=K, c=C,
                         delta=ps.corr)
    if backend.startswith("pruned"):
        assert bk.stats.fallback == ""
    want = mutated["ref_res"][B]
    full = Q._delta_bounds_batch(ps.rank_table, ps.query_users(), qs,
                                 ps.corr)
    live = ps.delta.user_live
    g_lo, g_up = got.r_lo.numpy(), got.r_up.numpy()
    w_lo, w_up = np.asarray(want.r_lo), np.asarray(want.r_up)
    assert np.isinf(g_lo[:, ~live]).all() and np.isinf(g_up[:, ~live]).all()
    differ = (g_lo != w_lo) | (g_up != w_up)
    if backend.startswith("pruned"):        # skipped rows read m' + 2
        kept = g_lo != float(ps.corr.selection_m() + 2)
        assert not differ[kept & live].any()
    else:
        assert not differ.any()
    if not backend.startswith("pruned"):    # a pruned bound reads m + 2
        np.testing.assert_array_equal(g_lo, full[0].numpy())
    key = Q.lemma1_key(*full, R_lo_k=got.R_lo_k, R_up_k=got.R_up_k, c=C,
                       m_items=ps.corr.selection_m())[0].numpy()
    np.testing.assert_array_equal(got.R_lo_k.numpy(), np.asarray(want.R_lo_k))
    np.testing.assert_array_equal(got.R_up_k.numpy(), np.asarray(want.R_up_k))
    for b in range(B):
        kth = np.sort(key[b])[K - 1]
        for u in set(got.indices[b].tolist()) ^ set(
                np.asarray(want.indices[b]).tolist()):
            assert key[b, u] <= kth + 1e-3, (b, u)
    assert not np.isin(got.indices.numpy(), np.flatnonzero(~live)).any()
    same = (got.indices.numpy()[:, :, None]
            == np.asarray(want.indices)[:, None, :])
    np.testing.assert_allclose(
        got.est_rank.numpy()[same.any(axis=2)],
        np.asarray(want.est_rank)[same.any(axis=1)], rtol=EST_RTOL)


def test_delta_query_is_the_batch_of_one(mutated):
    eng = mutated["port"]
    q = torch.from_numpy(mutated["qs"][1][0])
    one = eng.query(q, K, C)
    batch = eng.query_batch(q[None], K, C)
    for a, b in zip(one, batch):
        assert torch.equal(a, b[0])


# ---------------------------------------------------------------- counts
def _np_code(v, off, sc):
    return np.clip(np.floor((v - off) / sc), -128.0, 127.0).astype(np.int8)


def _np_above(rows, vals):
    width = rows.shape[1]
    return np.stack([width - np.searchsorted(r, v, side="right")
                     for r, v in zip(rows, vals)]).astype(np.float32)


def _int8_variants(corr, scores, slack):
    """The int8 corrected bounds for every way XLA may contract each of
    the four code arguments s ∓ slack ∓ (½ + pad)·scale: {(which, fma):
    count} for which in add_lo/add_hi/del_lo/del_hi. The contracted value
    is the float64 s − h·sc rounded once to f32."""
    out = {}
    s_lo = (scores - slack).astype(np.float32)
    s_hi = (scores + slack).astype(np.float32)
    for side, rows, sc, off in (
            ("add", corr.add_scores, corr.add_scale, corr.add_off),
            ("del", corr.del_scores, corr.del_scale, corr.del_off)):
        rows, sc, off = rows.numpy(), sc.numpy(), off.numpy()
        for name, s, sign in (("hi", s_lo, -1.0), ("lo", s_hi, 1.0)):
            plain = (s + np.float32(sign) * (HALF * sc)).astype(np.float32)
            fma = (s.astype(np.float64) + sign * np.float64(HALF)
                   * sc.astype(np.float64)).astype(np.float32)
            for is_fma, v in ((False, plain), (True, fma)):
                out[(side + "_" + name, is_fma)] = _np_above(
                    rows, _np_code(v, off, sc))
    return out


def _correction_inputs(mutated):
    """The reference's correction, scores, slack and some bounds."""
    rs = mutated["ref"].current_snapshot()
    qs = jnp.asarray(mutated["qs"][16])
    scores, slack = ref_user_scores_batch(rs.query_users(), qs)
    rng = np.random.default_rng(3)
    r_lo = rng.uniform(1, 200, scores.shape).astype(np.float32)
    r_up = r_lo + rng.uniform(0, 200, scores.shape).astype(np.float32)
    est = 0.5 * (r_lo + r_up)
    return rs.corr, scores, slack, r_lo, r_up, est


@pytest.mark.parametrize("mode", ["as_written", "jit"])
def test_apply_delta_corrections_against_the_reference(mutated, mode):
    corr, scores, slack, r_lo, r_up, est = _correction_inputs(mutated)
    args = tuple(jnp.asarray(x) for x in (r_lo, r_up, est))
    if mode == "as_written":
        with jax.disable_jit():
            want = R.apply_delta_corrections(scores, *args, corr,
                                             slack=slack)
    else:
        want = jax.jit(R.apply_delta_corrections)(scores, *args, corr,
                                                  slack=slack)
    pc = convert.correction_from_reference(corr, device="cpu")
    sc = torch.from_numpy(np.array(scores))
    sl = None if slack is None else torch.from_numpy(np.array(slack))
    got = T.apply_delta_corrections(
        sc, *(torch.from_numpy(x) for x in (r_lo, r_up, est)), pc, slack=sl)
    dead = ~np.asarray(corr.user_live)
    for g, w in zip(got, want):
        assert np.all(np.isinf(g.numpy()[dead]))
    contracted = mutated["spec"] == "int8" and mode == "jit"
    if not contracted:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=EST_RTOL)
        return
    var = _int8_variants(pc, sc.numpy(), sl.numpy())
    top = float(pc.m_new) + 1.0
    # the port computes as written: the plain variants exactly
    plain_lo = np.clip(r_lo + (var[("add_lo", False)]
                               - var[("del_hi", False)]), 1.0, top)
    live = ~dead
    np.testing.assert_array_equal(got[0].numpy()[live], plain_lo[live])
    for out, a, dl, base in ((0, "add_lo", "del_hi", r_lo),
                             (1, "add_hi", "del_lo", r_up)):
        cands = [np.clip(base + (var[(a, fa)] - var[(dl, fd)]), 1.0, top)
                 for fa in (False, True) for fd in (False, True)]
        g, w = got[out].numpy(), np.asarray(want[out])
        differ = (g != w) & live[:, None]
        ok = np.zeros_like(differ)
        for cand in cands:
            ok |= cand == w
        assert np.all(ok[differ]), out


def test_count_ranges_contain_the_exact_counts(mutated):
    """Quantized count ranges bracket the f32 count of the same scores;
    the f32 sets give it exactly (−inf / −128 padding never counts)."""
    ps = mutated["port"].current_snapshot()
    users = ps.users
    qs = torch.from_numpy(mutated["qs"][16])
    scores, slack = Q.user_scores_batch(ps.query_users(), qs)
    exact_scores = users @ qs.T
    add = users @ ps.delta.added_items.T
    cnt = (add[:, :, None] > exact_scores[:, None, :]).sum(1).float()
    if mutated["spec"] == "f32":
        assert torch.equal(T._count_above(ps.corr.add_scores, scores), cnt)
        return
    lo, hi = T._count_above_range(ps.corr.add_scores, ps.corr.add_scale,
                                  ps.corr.add_off, scores, slack)
    assert bool((lo <= cnt).all()) and bool((cnt <= hi).all())
    assert float((hi - lo).mean()) < 2.0


def test_delta_correction_counts_brute_force():
    """tests/test_index.py:84 on the port: bucket padding (−inf counts as
    zero) and the dead-user sentinel."""
    users, items = int_problem(4)
    rng = np.random.default_rng(0)
    u = torch.from_numpy(users)
    add = torch.from_numpy(rng.normal(size=(5, DIM)).astype(np.float32))
    dead = torch.from_numpy(rng.normal(size=(3, DIM)).astype(np.float32))
    qs = torch.from_numpy(items[:4] * (1 + 1e-4 * rng.normal(
        size=(4, DIM))).astype(np.float32))
    scores = u @ qs.T
    ones = torch.ones_like(scores)
    live = torch.ones(N, dtype=torch.bool)
    live[7] = False
    m_new = M - 3 + 5
    corr = DeltaCorrection(D._sorted_padded(u @ add.T, 5),
                           D._sorted_padded(u @ dead.T, 3), live, m_new)
    assert corr.add_scores.shape == (N, 8)
    g_lo, g_up, g_est = T.apply_delta_corrections(
        scores, 10.0 * ones, 30.0 * ones, 20.0 * ones, corr)
    sc = scores.numpy()
    cnt = (((u @ add.T).numpy()[:, :, None] > sc[:, None, :]).sum(1)
           - ((u @ dead.T).numpy()[:, :, None] > sc[:, None, :]).sum(1))
    lv = live.numpy()
    np.testing.assert_array_equal(g_lo.numpy()[lv],
                                  np.clip(10.0 + cnt, 1, m_new + 1)[lv])
    np.testing.assert_array_equal(g_up.numpy()[lv],
                                  np.clip(30.0 + cnt, 1, m_new + 1)[lv])
    np.testing.assert_array_equal(g_est.numpy()[7], np.full(4, np.inf))
    ref_corr = RefCorrection(jnp.asarray(corr.add_scores.numpy()),
                             jnp.asarray(corr.del_scores.numpy()),
                             jnp.asarray(lv), jnp.asarray(m_new, jnp.int32))
    np.testing.assert_array_equal(
        corr.add_scores.numpy(),
        np.asarray(RD._sorted_padded(jnp.asarray((u @ add.T).numpy()), 5)))
    want = R.apply_delta_corrections(jnp.asarray(sc), *(jnp.asarray(
        x.numpy()) for x in (10 * ones, 30 * ones, 20 * ones)), ref_corr)
    for g, w in zip((g_lo, g_up, g_est), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_dead_user_never_outranks_shifted_live_user():
    """A live user whose insertion-shifted estimate passes m' + 1 still
    outranks a deleted one: only +inf dominates every shifted estimate."""
    m_base, n_add, n_del = 10, 4, 2
    m_new = m_base - n_del + n_add
    corr = DeltaCorrection(
        add_scores=torch.tensor([[-1.0] * 4, [1.0] * 4, [-1.0] * 4]),
        del_scores=torch.zeros((3, 0)),
        user_live=torch.tensor([True, True, False]), m_new=m_new)
    g_lo, g_up, g_est = T.apply_delta_corrections(
        torch.zeros((3, 1)), torch.tensor([[2.0], [10.0], [3.0]]),
        torch.tensor([[4.0], [11.0], [5.0]]),
        torch.tensor([[3.0], [11.0], [4.0]]), corr)
    assert float(g_est[1, 0]) == 15.0
    res = Q.select_topk(g_lo.T, g_up.T, g_est.T, k=2, c=2.0,
                        m_items=corr.m_new)
    want = ref_select_topk(*(jnp.asarray(x.T.numpy())
                             for x in (g_lo, g_up, g_est)),
                           k=2, c=2.0, m_items=jnp.asarray(m_new))
    assert res.indices[0].tolist() == [0, 1] == np.asarray(
        want.indices)[0].tolist()


# ---------------------------------------------------------------- engine
def own_engine(spec="f32", backend="dense", seed=1, **kw):
    users, items_all = int_problem()
    _, cfg = cfgs(spec, **kw)
    return ReverseKRanksEngine.build(
        torch.from_numpy(users), torch.from_numpy(items_all[:M]), cfg, seed,
        backend=backend, device="cpu"), items_all


@pytest.mark.parametrize("spec", SPECS)
def test_insert_then_rebuild_equals_scratch(spec):
    """insert → delete → rebuild is a build from scratch over the live
    items with the same seed, bitwise, and answers the same."""
    eng, items_all = own_engine(spec)
    ids = eng.insert_items(torch.from_numpy(items_all[M:]))
    eng.delete_items(list(range(8)) + [int(ids[0])])
    merged = eng.live_items()
    assert merged.shape[0] == M + EXTRA - 9
    rec = eng.rebuild()
    assert rec is not None and rec.epoch_after == eng.epoch == 3
    assert rec.stats.n_added == EXTRA - 1 and rec.stats.n_deleted == 8
    snap = eng.current_snapshot()
    assert snap.delta.is_empty and snap.corr is None
    scratch = ReverseKRanksEngine.build(eng.users, merged, eng.config, 1,
                                        device="cpu")
    for f in snap.rank_table._fields:
        a, b = getattr(snap.rank_table, f), getattr(scratch.rank_table, f)
        assert a == b if f == "m" else (a is None and b is None) or \
            torch.equal(a, b), f
    qs = merged[:6]
    a, b = eng.query_batch(qs, K, C), scratch.query_batch(qs, K, C)
    for f in ("indices", "est_rank", "r_lo", "r_up"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert set(ids[1:]) <= set(eng.live_item_ids().tolist())
    assert eng.rebuild().stats.delta_ratio == 0.0


def test_rebuild_with_the_reference_positions():
    """A port engine from the reference's samples, rebuilt with the
    reference's samples over the live items: the reference's rebuilt
    base (sample ids, norm order), a table bitwise a port build from
    scratch on them, and the reference's table up to the rounding of its
    jitted threshold grid."""
    users, items_all = int_problem()
    rcfg, pcfg = cfgs()
    key = jax.random.PRNGKey(1)
    ref = RefEngine.build(jnp.asarray(users), jnp.asarray(items_all[:M]),
                          rcfg, key)
    pos, w = R.stratified_sample_indices(key, M, rcfg)
    port = ReverseKRanksEngine.build(
        torch.from_numpy(users), torch.from_numpy(items_all[:M]), pcfg, None,
        positions=torch.from_numpy(np.array(pos)),
        weights=torch.from_numpy(np.array(w)), device="cpu")
    for eng, t in ((ref, jnp.asarray), (port, torch.from_numpy)):
        eng.insert_items(t(items_all[M:]))
        eng.delete_items([0, 1, 2, 300])
    with pytest.raises(ValueError, match="positions"):
        port.rebuild()
    live = np.asarray(ref.live_items())
    art = R.sampling_artifacts(jnp.asarray(live), rcfg, key)
    ref.rebuild()
    port.rebuild(positions=torch.from_numpy(np.array(art.positions)),
                 weights=torch.from_numpy(np.array(art.weights)))
    rs, ps = ref.current_snapshot(), port.current_snapshot()
    np.testing.assert_array_equal(ps.base.sample_ids, rs.base.sample_ids)
    np.testing.assert_array_equal(ps.base.order.numpy(),
                                  np.asarray(art.order))
    np.testing.assert_array_equal(ps.base.item_ids, rs.base.item_ids)
    assert ps.rank_table.m == int(rs.rank_table.m) == M + EXTRA - 4
    # the table of a port build on those samples, and the reference's to
    # the rounding of its jitted threshold grid: a cell differs only
    # where a sample score lies between the two thresholds
    scratch = ReverseKRanksEngine.build(
        port.users, port.live_items(), pcfg, None,
        positions=ps.base.positions, weights=ps.base.weights, device="cpu")
    assert torch.equal(scratch.rank_table.table, ps.rank_table.table)
    assert torch.equal(scratch.rank_table.thresholds,
                       ps.rank_table.thresholds)
    thr_p, thr_r = ps.rank_table.thresholds.numpy(), np.asarray(
        rs.rank_table.thresholds)
    scale = np.abs(thr_r).max(axis=1, keepdims=True)
    assert np.all(np.abs(thr_p - thr_r) <= 2.0 ** -22 * scale)
    sc = port.users.numpy() @ ps.base.samples.numpy().T
    lo, hi = np.minimum(thr_p, thr_r), np.maximum(thr_p, thr_r)
    between = ((sc[:, :, None] >= lo[:, None, :])
               & (sc[:, :, None] <= hi[:, None, :])).any(axis=1)
    differ = ps.rank_table.table.numpy() != np.asarray(rs.rank_table.table)
    assert not (differ & ~between).any()


def test_rebuild_rebases_mid_build_mutations():
    """Mutations that land while a rebuild builds survive the swap: late
    inserts as a residual delta, a late user deletion, and a user
    upserted before the capture and again mid-build keeps the later
    vector's row."""
    eng, items_all = own_engine()
    rng = np.random.default_rng(9)
    eng.insert_items(torch.from_numpy(items_all[M:M + 8]))
    eng.upsert_users(torch.from_numpy(
        rng.integers(-4, 5, (1, DIM)).astype(np.float32)), indices=[5])
    v_final = torch.from_numpy(rng.integers(-4, 5, (1, DIM)).astype(
        np.float32))
    orig = eng._backend.build_index
    late = []

    def slow_build(*args, **kw):
        rt = orig(*args, **kw)
        late.append(eng.insert_items(torch.from_numpy(items_all[M + 8:])))
        eng.delete_users([11])
        eng.upsert_users(v_final, indices=[5])
        eng.upsert_users(v_final)                   # appended mid-build
        return rt

    eng._backend.build_index = slow_build
    try:
        rec = eng.rebuild()
    finally:
        eng._backend.build_index = orig
    assert rec is not None
    snap = eng.current_snapshot()
    assert snap.rank_table.m == M + 8 and snap.delta.n_added == EXTRA - 8
    assert set(late[0]) <= set(eng.live_item_ids().tolist())
    assert not snap.delta.user_live[11] and snap.n == N + 1
    assert torch.equal(snap.users[5], v_final[0])
    thr, tab = T.recompute_user_rows(v_final, snap.base.samples,
                                     snap.base.weights, eng.config)
    for row in (5, N):
        assert torch.equal(snap.rank_table.table[row], tab[0])
        assert torch.equal(snap.rank_table.thresholds[row], thr[0])
    res = eng.query_batch(torch.from_numpy(items_all[:4]), K, C)
    assert 11 not in res.indices.numpy()


@pytest.mark.parametrize("spec", SPECS)
def test_upserted_rows_match_a_scratch_build(spec):
    """An upserted user's rows equal a build from scratch over the
    modified users (same seed) to the reference's tolerance, and every
    other row bitwise; the older snapshot is untouched."""
    eng, items_all = own_engine(spec)
    old = eng.current_snapshot()
    kept = [x.clone() for x in old.rank_table if isinstance(x, torch.Tensor)]
    kept_users = old.users.clone()
    rng = np.random.default_rng(6)
    v = torch.from_numpy(rng.integers(-4, 5, (2, DIM)).astype(np.float32))
    eng.upsert_users(v, indices=[5, 77])
    users2 = old.users.clone()
    users2[[5, 77]] = v
    scratch = ReverseKRanksEngine.build(users2, torch.from_numpy(
        items_all[:M]), eng.config, 1, device="cpu")
    got, want = eng.rank_table, scratch.rank_table
    mask = np.ones(N, bool)
    mask[[5, 77]] = False
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        if f == "m" or a is None:
            continue
        np.testing.assert_array_equal(_np(a)[mask], _np(b)[mask], f)
    if spec == "f32":
        np.testing.assert_allclose(got.thresholds.numpy(),
                                   want.thresholds.numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(got.table.numpy(), want.table.numpy(),
                                   rtol=1e-6, atol=0)
    assert all(torch.equal(a, b) for a, b in zip(
        kept, [x for x in old.rank_table if isinstance(x, torch.Tensor)]))
    assert torch.equal(kept_users, old.users)
    assert eng.current_snapshot().rank_table.table is not old.rank_table.table


def test_append_and_delete_users():
    eng, items_all = own_engine(backend="fused")
    qs = torch.from_numpy(items_all[:4])
    before = eng.query_batch(qs, K, C)
    victim = int(before.indices[0, 0])
    rng = np.random.default_rng(8)
    idx = eng.upsert_users(torch.from_numpy(
        rng.integers(-4, 5, (3, DIM)).astype(np.float32)))
    assert list(idx) == [N, N + 1, N + 2] and eng.n == N + 3
    assert eng.rank_table.thresholds.shape == (N + 3, 16)
    assert eng.query_batch(qs, K, C).indices.shape == (4, K)
    eng.delete_users([victim])
    after = eng.query_batch(qs, K, C)
    assert victim not in after.indices.numpy()
    assert np.all(np.isinf(after.r_lo.numpy()[:, victim]))
    snap = eng.current_snapshot()
    # a mask-only mutation reuses the score sets it does not change
    eng.delete_users([1])
    assert eng.current_snapshot().corr.add_scores is snap.corr.add_scores
    with pytest.raises(IndexError):
        eng.delete_users([N + 3])
    with pytest.raises(ValueError, match="duplicate"):
        eng.upsert_users(torch.zeros((2, DIM)), indices=[1, 1])
    with pytest.raises(KeyError):
        eng.delete_items([10 ** 6])


def test_compose_remaps_identity_and_absorption():
    first = np.asarray([2, -1, 0, 1], np.int64)
    second = np.asarray([1, -1, 0], np.int64)
    assert compose_remaps(None, None) is None
    for a, b in ((None, first), (first, None), (first, second)):
        np.testing.assert_array_equal(compose_remaps(a, b),
                                      ref_compose_remaps(a, b))
    np.testing.assert_array_equal(compose_remaps(first, second),
                                  np.asarray([0, -1, 1, -1], np.int64))


def test_compact_then_reorder_composes_remap():
    """A compacting, reordering rebuild, then another, composes
    `user_remap` onto the lineage: each original row still alive sits at
    remap[orig] with its vector, dropped rows stay −1, and
    `client_user_ids` maps answers back to an engine that only masks."""
    users, items_all = int_problem()
    _, cfg = cfgs(threshold_mode="exact")
    u, it = torch.from_numpy(users), torch.from_numpy(items_all[:M])
    eng = ReverseKRanksEngine.build(u, it, cfg, 1, device="cpu")
    dead = list(range(0, N, 3))
    eng.delete_users(dead)
    rec = eng.rebuild(compact_dead_above=0.2, reorder_clusters=True)
    assert rec.users_compacted == len(dead) and rec.users_reordered
    snap = eng.current_snapshot()
    remap = snap.user_remap
    alive = np.setdiff1d(np.arange(N), dead)
    assert np.all(remap[dead] == -1)
    assert np.array_equal(np.sort(remap[alive]), np.arange(alive.size))
    np.testing.assert_array_equal(snap.users.numpy()[remap[alive]],
                                  users[alive])
    assert torch.equal(eng.user_remap, torch.from_numpy(remap))
    masked = ReverseKRanksEngine.build(u, it, cfg, 1, device="cpu")
    masked.delete_users(dead)
    qs = torch.from_numpy(0.5 * np.random.default_rng(7).normal(
        size=(4, DIM)).astype(np.float32))
    got, want = eng.query_batch(qs, K, C), masked.query_batch(qs, K, C)
    np.testing.assert_array_equal(got.r_lo.numpy()[:, remap[alive]],
                                  want.r_lo.numpy()[:, alive])
    np.testing.assert_array_equal(
        snap.client_user_ids(got.indices), want.indices.numpy())
    dead2 = np.arange(0, snap.n, 5)
    dead2_orig = snap.client_user_ids(dead2)
    eng.delete_users(dead2.tolist())
    rec2 = eng.rebuild(compact_dead_above=0.1, reorder_clusters=True)
    assert rec2.users_compacted == dead2.size
    remap2 = eng.current_snapshot().user_remap
    assert remap2.shape == (N,)
    assert np.all(remap2[dead] == -1) and np.all(remap2[dead2_orig] == -1)
    alive2 = np.flatnonzero(remap2 >= 0)
    np.testing.assert_array_equal(
        eng.users.numpy()[remap2[alive2]], users[alive2])
    eng.rebuild()
    np.testing.assert_array_equal(eng.current_snapshot().user_remap, remap2)


def test_residual_follows_the_compacted_layout():
    """Items inserted mid-build of a compacting, reordering rebuild stay
    as a residual delta whose rows follow the published layout."""
    users, items_all = int_problem()
    _, cfg = cfgs(threshold_mode="exact")
    u, it = torch.from_numpy(users), torch.from_numpy(items_all[:M])
    eng = ReverseKRanksEngine.build(u, it, cfg, 1, device="cpu")
    dead = list(range(0, N, 3))
    eng.delete_users(dead)
    late = torch.from_numpy(items_all[M:M + 8])
    orig = eng._backend.build_index

    def slow_build(*args, **kw):
        rt = orig(*args, **kw)
        eng.insert_items(late)
        return rt

    eng._backend.build_index = slow_build
    try:
        eng.rebuild(compact_dead_above=0.2, reorder_clusters=True)
    finally:
        eng._backend.build_index = orig
    snap = eng.current_snapshot()
    assert snap.delta.n_added == 8 and snap.corr.add_scores.shape[0] == \
        N - len(dead)
    masked = ReverseKRanksEngine.build(u, it, cfg, 1, device="cpu")
    masked.delete_users(dead)
    masked.insert_items(late)
    alive = np.setdiff1d(np.arange(N), dead)
    np.testing.assert_array_equal(
        snap.corr.add_scores.numpy()[snap.user_remap[alive]],
        masked.current_snapshot().corr.add_scores.numpy()[alive])


def test_delta_stats_and_stale_weight():
    eng, items_all = own_engine()
    st = eng.delta_stats()
    assert st.delta_ratio == 0.0 and st.stale_weight == 0.0
    assert eng.correction_overhead() == 1.0
    eng.insert_items(torch.from_numpy(items_all[M:M + 8]))
    sampled = int(eng.current_snapshot().base.sample_ids[0])
    eng.delete_items([sampled])
    st = eng.delta_stats()
    assert st.n_added == 8 and st.n_deleted == 1
    assert st.delta_ratio == pytest.approx(9 / M)
    assert st.stale_weight > 0.0 and st.m_live == M + 7
    assert eng.correction_overhead() > 0.0
    m0 = eng.memory_bytes()
    corr = eng.current_snapshot().corr
    assert m0 > 0 and corr.add_scores.numel() * 4 + corr.del_scores.numel() \
        * 4 + corr.user_live.numel() <= m0


def test_engine_without_items_rejects_item_mutations():
    users, items_all = int_problem()
    full, _ = own_engine()
    eng = ReverseKRanksEngine(full.users, full.rank_table, full.config)
    with pytest.raises(ValueError, match="base item set"):
        eng.insert_items(torch.zeros((1, DIM)))
    with pytest.raises(ValueError, match="base item set"):
        eng.rebuild()
    with pytest.raises(ValueError, match="positions= and weights="):
        ReverseKRanksEngine(full.users, full.rank_table, full.config,
                            items=torch.from_numpy(items_all[:M]))
    eng.delete_users([3])
    res = eng.query_batch(torch.from_numpy(items_all[:2]), K, C)
    assert 3 not in res.indices.numpy()


@pytest.mark.parametrize("inner", ["dense", "fused"])
def test_delta_guard_falls_back_to_the_inner_scan(inner, monkeypatch):
    from repro_torch.core import pruning as P
    monkeypatch.setattr(P, "DELTA_GUARD", 0.01)
    eng, items_all = own_engine(backend=PrunedBackend(
        inner, block_size=64, max_union_frac=1.0))
    qs = torch.from_numpy(items_all[:5])
    eng.insert_items(torch.from_numpy(items_all[M:]))
    eng.delete_items(range(4))
    got = eng.query_batch(qs, K, C)
    assert eng._backend.stats.fallback == "delta-guard"
    snap = eng.current_snapshot()
    want = get_backend(inner).query_batch(snap.rank_table, snap.users, qs,
                                          k=K, c=C, delta=snap.corr)
    for f in ("indices", "est_rank", "r_lo", "r_up"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    monkeypatch.setattr(P, "DELTA_GUARD", 0.25)
    eng.query_batch(qs, K, C)
    assert eng._backend.stats.fallback == ""


@pytest.mark.parametrize("B", [1, 8])
def test_delta_phase_a_is_bitwise_the_reference(mutated, B):
    """Phase A on a mutated index, fed the reference's summary of the
    mutated snapshot (boxes only: every product exact on integer
    inputs): keep and R̂ bitwise the reference's, with the padded widths
    and the live mask (a block of 64 rows, the tail partial)."""
    from repro.core import pruning as RP
    from repro_torch.core import pruning as P
    rs = mutated["ref"].current_snapshot()
    summ = RP.build_block_summary(rs.query_users(), rs.rank_table,
                                  block_size=64, with_cones=False)
    qs = mutated["items"][np.arange(B) * 29 % M]
    corr = rs.corr
    keep_w, rhat_w = RP.phase_a(summ, jnp.asarray(qs), k=K, block_size=64,
                                n_add=float(corr.n_add),
                                n_del=float(corr.n_del),
                                user_live=corr.user_live, with_live=True)
    keep_g, rhat_g = P.phase_a(
        convert.summary_from_reference(summ, device="cpu"),
        torch.from_numpy(qs), k=K, n_add=corr.n_add, n_del=corr.n_del,
        user_live=torch.from_numpy(np.array(corr.user_live)), block_size=64)
    np.testing.assert_array_equal(keep_g.numpy(), np.asarray(keep_w))
    np.testing.assert_array_equal(rhat_g.numpy(), np.asarray(rhat_w))


@pytest.mark.parametrize("inner", ["dense", "fused"])
def test_pruned_delta_selects_the_inner_full_scan(inner):
    """Clustered users and a hot-cluster batch, so that phase A prunes
    on the mutated index (forced past the union cap); the selection is
    bitwise the inner delta full scan's."""
    rng = np.random.default_rng(12)
    centers = rng.integers(-6, 7, (8, DIM))
    assign = np.arange(N) * 8 // N
    users = (centers[assign] + rng.integers(-1, 2, (N, DIM))).astype(
        np.float32)
    items = (centers[rng.integers(0, 8, M + EXTRA)] + rng.integers(
        -1, 2, (M + EXTRA, DIM))).astype(np.float32)
    _, cfg = cfgs()
    eng = ReverseKRanksEngine.build(
        torch.from_numpy(users), torch.from_numpy(items[:M]), cfg, 1,
        backend=PrunedBackend(inner, block_size=32, max_union_frac=1.0),
        device="cpu")
    eng.insert_items(torch.from_numpy(items[M:]))
    eng.delete_items([4, 5])
    eng.delete_users([0, 1, 2, 100, 200])
    qs = torch.from_numpy((2 * centers[3] + rng.integers(
        -1, 2, (6, DIM))).astype(np.float32))
    got = eng.query_batch(qs, K, C)
    st = eng._backend.stats
    assert st.fallback == "" and st.skip_rate > 0
    snap = eng.current_snapshot()
    want = get_backend(inner).query_batch(snap.rank_table, snap.users, qs,
                                          k=K, c=C, delta=snap.corr)
    for f in ("indices", "est_rank", "R_lo_k", "R_up_k", "guaranteed"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_snapshots_hold_under_concurrent_mutation():
    """Readers pin snapshots and query them while a writer mutates and
    rebuilds (more threads than cores, a short switch interval): every
    result equals the same query on its pinned snapshot afterwards (no
    mutation touched an older snapshot), and epochs only grow."""
    import sys
    import threading
    eng, items_all = own_engine(backend="fused")
    qs = torch.from_numpy(items_all[:4])
    seen, errors = [], []
    stop = threading.Event()

    def reader():
        try:
            while not stop.is_set():
                snap = eng.current_snapshot()
                seen.append((snap, eng.query_batch_at(snap, qs, K, C)))
        except Exception as e:          # noqa: BLE001 (reported below)
            errors.append(e)

    def writer():
        try:
            rng = np.random.default_rng(13)
            for i in range(3):
                ids = eng.insert_items(torch.from_numpy(
                    items_all[M + 4 * i:M + 4 * i + 4]))
                eng.delete_items([int(ids[0]), 10 + i])
                eng.upsert_users(torch.from_numpy(rng.integers(
                    -4, 5, (1, DIM)).astype(np.float32)), indices=[20 + i])
                eng.delete_users([30 + i])
            eng.rebuild()
        except Exception as e:          # noqa: BLE001 (reported below)
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        readers = [threading.Thread(target=reader) for _ in range(6)]
        w = threading.Thread(target=writer)
        for t in readers + [w]:
            t.start()
        w.join(timeout=120)
        stop.set()
        for t in readers:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not w.is_alive() and not any(t.is_alive() for t in readers)
    assert not errors, errors
    assert eng.epoch == 13 and len(seen) > 0
    epochs = sorted({snap.epoch for snap, _ in seen})
    assert len(epochs) > 1
    for snap, res in seen[::max(1, len(seen) // 40)]:
        again = eng.query_batch_at(snap, qs, K, C)
        for f in ("indices", "est_rank", "r_lo", "r_up"):
            assert torch.equal(getattr(res, f), getattr(again, f)), f


# --------------------------------------------------- quality end to end
# phase 4d's churn at Netflix size (chip_smoke.CHURN), as fractions of
# m = 17,770 items and n = 480,189 users
CHURN_FRACTIONS = dict(insert=96 / 17770, delete=64 / 17770,
                       upsert=32 / 480189, append=32 / 480189,
                       dead=48 / 480189)


def mutated_ratios(n, m, d, tau, nq=16, k=10, c=2.0):
    """Phase 4d's churn proportions (at least one of each) applied to one
    index in each package, the port's started from the reference's table,
    positions and weights; both mutated selections (and both after a
    rebuild, the port fed the reference's draw over the live items)
    graded by ONE oracle over the live users and items. Returns {(stage,
    package): (overall ratio, accuracy)} and the selections."""
    from repro_torch.core import exact, metrics
    from repro_torch.data.pipeline import synthetic_embeddings
    cnt = {key: max(1, round(f * (m if key in ("insert", "delete") else n)))
           for key, f in CHURN_FRACTIONS.items()}
    U, I = (x.numpy() for x in synthetic_embeddings(
        0, n + cnt["upsert"] + cnt["append"], m + cnt["insert"], d,
        device="cpu"))
    users, items = U[:n], I[:m]
    rcfg, pcfg = (RefConfig(tau=tau, omega=10, s=64),
                  RankTableConfig(tau=tau, omega=10, s=64))
    key = jax.random.PRNGKey(1)
    ref = RefEngine.build(jnp.asarray(users), jnp.asarray(items), rcfg, key)
    pos, w = R.stratified_sample_indices(key, m, rcfg)
    st = convert.from_reference(ref.rank_table, users, items, pos, w,
                                device="cpu")
    port = ReverseKRanksEngine(st.users, st.rank_table, pcfg,
                               items=st.items, positions=st.positions,
                               weights=st.weights)
    rng = np.random.default_rng(3)
    qids = rng.permutation(m)[:nq]
    dels = sorted(rng.choice(np.setdiff1d(np.arange(m), qids),
                             cnt["delete"], replace=False).tolist())
    perm = rng.permutation(n)
    up_idx = sorted(perm[:cnt["upsert"]].tolist())
    dead = sorted(perm[cnt["upsert"]:cnt["upsert"] + cnt["dead"]].tolist())
    up = U[n:n + cnt["upsert"]]
    app = U[n + cnt["upsert"]:]
    for e, arr in ((ref, jnp.asarray), (port, torch.from_numpy)):
        e.insert_items(arr(I[m:]))
        e.delete_items(dels)
        e.upsert_users(arr(up), indices=up_idx)
        e.upsert_users(arr(app))
        e.delete_users(dead)
    snap = port.current_snapshot()
    live = snap.delta.user_live
    np.testing.assert_array_equal(np.asarray(ref.current_snapshot().users),
                                  snap.users.numpy())
    live_items = port.live_items()
    np.testing.assert_array_equal(np.asarray(ref.live_items()),
                                  live_items.numpy())
    row_of = np.cumsum(live) - 1
    users_live = snap.users[torch.from_numpy(live)]
    qs = items[qids]
    truth = [exact.exact_ranks(users_live, live_items,
                               torch.from_numpy(q)).numpy() for q in qs]

    def grade(indices):
        out = []
        for b, tr in enumerate(truth):
            ex = np.argsort(tr, kind="stable")[:k]
            got = row_of[np.asarray(indices[b])]
            out.append((metrics.overall_ratio(got, ex, tr),
                        metrics.accuracy(got, ex, tr, c)))
        return tuple(np.mean(out, axis=0))

    out, sel = {}, {}
    for stage in ("mutated", "rebuilt"):
        if stage == "rebuilt":
            ref.rebuild()
            p2, w2 = R.stratified_sample_indices(key, live_items.shape[0],
                                                 rcfg)
            port.rebuild(positions=torch.from_numpy(np.array(p2)),
                         weights=torch.from_numpy(np.array(w2)))
        for name, idx in (
                ("reference", np.asarray(ref.query_batch(
                    jnp.asarray(qs), k, c).indices)),
                ("port", port.query_batch(torch.from_numpy(qs), k,
                                          c).indices.numpy())):
            sel[(stage, name)] = idx
            out[(stage, name)] = grade(idx)
    return out, sel


def test_mutated_overall_ratio_is_the_references():
    """The port adds no fault to the mutated index's quality at this
    size: with phase 4d's churn proportions, both packages select the
    same users on the mutated index and after a rebuild, so one oracle
    grades them to the same §5 overall ratio and accuracy."""
    out, sel = mutated_ratios(n=2048, m=2000, d=32, tau=64)
    for stage in ("mutated", "rebuilt"):
        np.testing.assert_array_equal(sel[(stage, "port")],
                                      sel[(stage, "reference")])
        assert out[(stage, "port")] == out[(stage, "reference")]
        ratio, acc = out[(stage, "port")]
        assert ratio >= 1.0 and 0.0 <= acc <= 1.0


# ------------------------------------------------------------- the card
@pytest.mark.cuda
def test_mutable_index_checks_on_card():
    """Phase 4d of chip_smoke.py at a small size: checks (a)-(g) on the
    card (K1-K7 through the delta path). On a GPU machine:
    PYTHONPATH=src:. python -m pytest -m cuda tests/test_torch_index.py"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import chip_smoke
    report = chip_smoke.mutable_index_checks(
        torch.device("cuda"), n=6000, m=700, d=24, tau=32, n_insert=20,
        n_delete=12, n_upsert=5, n_append=5, n_dead=7, timing=False)
    assert report["checks"] == list("abcdefg")


if __name__ == "__main__":
    # the quality comparison at a given size:
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_index.py \
    #       N M D TAU
    import sys
    res, _ = mutated_ratios(*(int(a) for a in sys.argv[1:5]))
    for (stage, name), (ratio, acc) in sorted(res.items()):
        print(f"{stage} {name}: overall ratio {ratio!r}, accuracy {acc!r}")
