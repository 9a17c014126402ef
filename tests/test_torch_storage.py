"""The port's storage tier (bf16 and int8) against the JAX reference, one
stage at a time, each on the reference's own state where the stage under
test does not produce that state itself:

  pack     `StorageSpec.pack_table` / `pack_users` on the reference's f32
           arrays: codes, scales, offsets, bf16 casts, user rows and
           slack bitwise; `thr_dev` as a certificate (see its test);
  lookup   the dense step 1 on the reference's packed `RankTable` and
           `StoredUsers`, carried across by `convert.from_reference`;
  fused    the plain version of K4/K5 through `ops` (the CPU path):
           bitwise the dense path, and the reference's Pallas run;
  engine   the quickstart flow at bf16 and int8 on both backends.

Lookup inputs are integer-valued, so every score and every ‖q‖₁ is exact
in any summation order and small integers are exact in bf16: the two
packages then see the same scores and slacks, and r↓/r↑ compare exactly.

Two reference behaviours shape the comparisons. (1) The reference's
arithmetic as written (its functions run op by op, `jax.disable_jit()`)
is what the port computes, and r↓/r↑ equal it bitwise. Under `jit`,
XLA's CPU compiler contracts the int8 dequantization code·sc + off into
one fused multiply-add, which moves the last bit of an int8 r↓/r↑; there
every differing cell must equal that contracted value exactly
(`_explained_by_contraction`), so no tolerance is involved. (2) est
involves divisions and exp: 1e-5 relative, as in the f32 tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as ref_metrics
from repro.core.engine import ReverseKRanksEngine as RefEngine
from repro.core.exact import exact_ranks as ref_exact_ranks
from repro.core.exact import reverse_k_ranks as ref_reverse_k_ranks
from repro.core.query import bound_ranks_batch as ref_bound_ranks_batch
from repro.core.query import user_scores_batch as ref_user_scores_batch
from repro.core.rank_table import build_rank_table
from repro.core.types import RankTableConfig as RefConfig
from repro.core.types import StorageSpec as RefSpec
from repro.data.pipeline import synthetic_embeddings as ref_synthetic
from repro.kernels import ops as rops
from repro_torch.convert import from_reference
from repro_torch.core import metrics
from repro_torch.core import query as Q
from repro_torch.core import rank_table as rt_mod
from repro_torch.core.engine import ReverseKRanksEngine
from repro_torch.core.exact import exact_ranks, reverse_k_ranks
from repro_torch.core.types import RankTable, RankTableConfig, \
    StorageSpec, StoredUsers, _int8_code_grid
from repro_torch.data.pipeline import synthetic_embeddings
from repro_torch.kernels import ops, ref


SPECS = ("bf16", "int8")
EST_RTOL = 1e-5
# the certified containment tolerance of tests/test_storage.py
CONTAIN_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads, so torch does not starve the timing-sensitive
    tests that share the run."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _np(t: torch.Tensor) -> np.ndarray:
    """A port tensor as numpy; bf16 as its 16-bit pattern."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _ref_np(a) -> np.ndarray:
    """A reference array as numpy; bf16 as its 16-bit pattern."""
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


# ------------------------------------------------------------------ pack
@pytest.fixture(scope="module")
def f32_table():
    """A reference f32 rank table on Gaussian embeddings (not integers:
    the pack must agree on arbitrary f32 values)."""
    rng = np.random.default_rng(3)
    users = rng.standard_normal((600, 16)).astype(np.float32)
    items = (rng.standard_normal((400, 16))
             * np.abs(1.0 + 0.3 * rng.standard_normal((400, 1)))
             ).astype(np.float32)
    rt = build_rank_table(jnp.asarray(users), jnp.asarray(items),
                          RefConfig(tau=200, omega=4, s=16),
                          jax.random.PRNGKey(0))
    return (np.array(users), np.array(rt.thresholds), np.array(rt.table))


@pytest.mark.parametrize("spec", SPECS)
def test_pack_table_is_bitwise_the_reference(f32_table, spec):
    _, thr, tab = f32_table
    want = RefSpec.parse(spec).pack_table(jnp.asarray(thr), jnp.asarray(tab))
    got = StorageSpec.parse(spec).pack_table(torch.from_numpy(thr),
                                             torch.from_numpy(tab), m=7)
    assert got.spec_kind == want.spec_kind == spec
    assert got.m == 7
    fields = ["thresholds", "table"]
    if spec == "int8":
        fields += ["thr_scale", "thr_off", "tab_scale", "tab_off"]
    else:
        assert all(getattr(got, f) is None for f in RankTable._fields[3:])
    stored = {"bf16": torch.bfloat16, "int8": torch.int8}[spec]
    for f in fields:
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      _ref_np(getattr(want, f)), f)
        assert getattr(got, f).dtype == (
            stored if f in ("thresholds", "table") else torch.float32), f


def test_thr_dev_is_a_certificate(f32_table):
    """thr_dev cannot be bitwise the reference's: the reference measures
    the deviation against `jnp.linspace(-127, 127, τ)` in f32, whose
    values XLA computes in its own way (neither `torch.linspace` nor the
    formula start·(1−t) + stop·t in torch reproduces them), while the port
    uses the grid rounded once from double. The two grids differ by up to
    ~1.5e-5 code units. So thr_dev is held as what it is for: at least
    the exact deviation, computed in float64 against the exact grid
    −127 + j·254/(τ−1), less 2e-5; and within 2e-5 of the reference's."""
    _, thr, tab = f32_table
    want = RefSpec("int8").pack_table(jnp.asarray(thr), jnp.asarray(tab))
    got = StorageSpec("int8").pack_table(torch.from_numpy(thr),
                                         torch.from_numpy(tab))
    tau = thr.shape[1]
    codes = (thr.astype(np.float64) - _np(got.thr_off)) / _np(got.thr_scale)
    exact_grid = -127.0 + np.arange(tau) * (254.0 / (tau - 1))
    dev64 = np.abs(codes - exact_grid).max(axis=1, keepdims=True)
    port = _np(got.thr_dev).astype(np.float64)
    assert got.thr_dev.shape == (thr.shape[0], 1)
    assert np.all(port >= dev64 - 2e-5)
    np.testing.assert_allclose(port, np.asarray(want.thr_dev), rtol=0,
                               atol=2e-5)
    # the port's grid is the exact grid rounded once to f32
    np.testing.assert_array_equal(
        _int8_code_grid(tau, "cpu").numpy()[0],
        exact_grid.astype(np.float32))


@pytest.mark.parametrize("spec", SPECS)
def test_pack_users_is_bitwise_the_reference(f32_table, spec):
    users = f32_table[0]
    want = RefSpec.parse(spec).pack_users(jnp.asarray(users))
    got = StorageSpec.parse(spec).pack_users(torch.from_numpy(users))
    assert isinstance(got, StoredUsers)
    assert got.shape == users.shape
    for f in StoredUsers._fields:
        if getattr(want, f) is None:
            assert getattr(got, f) is None, f
        else:
            np.testing.assert_array_equal(_np(getattr(got, f)),
                                          _ref_np(getattr(want, f)), f)


@pytest.mark.parametrize("spec", SPECS)
def test_stored_rows_matches_reference(f32_table, spec):
    from repro.core.types import stored_rows as ref_stored_rows
    from repro_torch.core.types import stored_rows
    users = f32_table[0]
    want = RefSpec.parse(spec).pack_users(jnp.asarray(users))
    got = StorageSpec.parse(spec).pack_users(torch.from_numpy(users))
    np.testing.assert_array_equal(_np(stored_rows(got)),
                                  _ref_np(ref_stored_rows(want)))
    raw = torch.from_numpy(users)
    assert stored_rows(raw) is raw


def test_f32_spec_packs_nothing(f32_table):
    users, thr, tab = f32_table
    spec = StorageSpec.parse("float32")
    assert spec.is_exact and spec.table_dtype == torch.float32
    assert spec.pack_users(torch.from_numpy(users)) is None
    rt = spec.pack_table(torch.from_numpy(thr), torch.from_numpy(tab))
    assert rt.spec_kind == "f32" and rt.thr_scale is None
    assert torch.equal(rt.thresholds, torch.from_numpy(thr))


@pytest.mark.parametrize("name", ["f32", "float32", "bf16", "bfloat16",
                                  "int8"])
def test_spec_parse_matches_reference(name):
    ours, theirs = StorageSpec.parse(name), RefSpec.parse(name)
    assert ours.kind == theirs.kind
    assert ours.is_exact == theirs.is_exact
    assert str(ours.table_dtype).split(".")[-1] == \
        jnp.dtype(theirs.table_dtype).name
    assert StorageSpec.parse(ours) is ours


@pytest.mark.parametrize("bad", ["float16", "fp8", "int4"])
def test_spec_rejects_what_reference_rejects(bad):
    with pytest.raises(ValueError):
        RefSpec.parse(bad)
    with pytest.raises(ValueError):
        StorageSpec.parse(bad)
    with pytest.raises(ValueError):
        StorageSpec(kind=bad)


# --------------------------------------------------------------- convert
@pytest.mark.parametrize("spec", SPECS)
def test_from_reference_round_trip_is_exact(f32_table, spec):
    users, thr, tab = f32_table
    rspec = RefSpec.parse(spec)
    rt = rspec.pack_table(jnp.asarray(thr), jnp.asarray(tab),
                          m=jnp.asarray(400, jnp.int32))
    su = rspec.pack_users(jnp.asarray(users))
    st = from_reference(rt, users, stored_users=su, device="cpu")
    assert st.rank_table.m == 400
    assert st.rank_table.spec_kind == spec
    for f in RankTable._fields:
        if f == "m":
            continue
        want = getattr(rt, f)
        got = getattr(st.rank_table, f)
        if want is None:
            assert got is None, f
            continue
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(_np(got), _ref_np(want), f)
    for f in StoredUsers._fields:
        want, got = getattr(su, f), getattr(st.stored_users, f)
        if want is None:
            assert got is None, f
        else:
            assert str(got.dtype) == "torch." + np.asarray(want).dtype.name
            np.testing.assert_array_equal(_np(got), _ref_np(want), f)


# ---------------------------------------------------------------- lookup
def _int_problem(seed, n=300, m=200, d=24):
    rng = np.random.default_rng(seed)
    users = rng.integers(-4, 5, (n, d)).astype(np.float32)
    items = rng.integers(-4, 5, (m, d)).astype(np.float32)
    return users, items


@pytest.fixture(scope="module", params=SPECS)
def int_state(request):
    """The reference's packed table and stored users over an integer
    problem, and the same state carried across."""
    spec = request.param
    users, items = _int_problem(11)
    cfg = RefConfig(tau=37, omega=4, s=16, storage_dtype=spec)
    rt = build_rank_table(jnp.asarray(users), jnp.asarray(items), cfg,
                          jax.random.PRNGKey(5))
    su = cfg.storage.pack_users(jnp.asarray(users))
    st = from_reference(rt, users, items, stored_users=su, device="cpu")
    return spec, users, items, rt, su, st


def _users(state, raw):
    """(reference users, port users): stored, or raw f32 (mixed)."""
    spec, users, _, _, su, st = state
    return (jnp.asarray(users), st.users) if raw else (su, st.stored_users)


def _explained_by_contraction(got, want, st, qs, raw):
    """Cells where the port's int8 r↓/r↑ differ from the jitted
    reference's must hold exactly XLA's contracted value
    fl(fma(code, sc, off) ∓ wid), wid = fl((½+pad)·sc). The fma is
    computed in float64, exact here (an 8-bit code times an f32 scale
    plus an f32 offset of similar magnitude fits in 53 bits)."""
    rt = st.rank_table
    users = st.users if raw else st.stored_users
    scores, slack = Q.user_scores_batch(users, torch.from_numpy(qs))
    idx_lo, idx_hi = Q.int8_indices(rt, scores, slack)
    tau = rt.tau
    _, _, widen_c = Q.int8_constants(tau)
    sc = rt.tab_scale.numpy()
    off = rt.tab_off.numpy()
    wid = (np.float32(widen_c) * sc).astype(np.float32)

    def fma_deq(col):
        code = np.take_along_axis(rt.table.numpy(), col.numpy(), axis=1)
        return (code.astype(np.float64) * sc.astype(np.float64)
                + off.astype(np.float64)).astype(np.float32)

    r_up = np.where(idx_lo.numpy() == 0, float(rt.m + 1),
                    fma_deq(torch.clamp(idx_lo - 1, 0, tau - 1)) + wid)
    r_lo = np.where(idx_hi.numpy() == tau, 1.0,
                    fma_deq(torch.clamp(idx_hi, 0, tau - 1)) - wid)
    for g, w, contracted in ((got[0], want[0], r_lo.T),
                             (got[1], want[1], r_up.T)):
        g, w = g.numpy(), np.asarray(w)
        differ = g != w
        np.testing.assert_array_equal(w[differ], contracted[differ])


@pytest.mark.parametrize("raw", [False, True], ids=["stored", "raw_users"])
@pytest.mark.parametrize("B", [1, 3, 16])
def test_lookup_exact_against_reference(int_state, B, raw):
    """Dense step 1 on the reference's packed state: r↓/r↑ bitwise the
    reference's arithmetic as written, est to 1e-5; against the jitted
    reference bitwise at bf16, and at int8 up to XLA's contraction."""
    spec, _, items, rt, _, st = int_state
    qs = items[np.arange(B) * 7 % items.shape[0]]
    ref_users, users = _users(int_state, raw)
    got = Q.bound_ranks_batch(st.rank_table, users, torch.from_numpy(qs))
    with jax.disable_jit():
        as_written = ref_bound_ranks_batch(rt, ref_users, jnp.asarray(qs))
    jitted = ref_bound_ranks_batch(rt, ref_users, jnp.asarray(qs))
    for g in got:
        assert g.shape == (B, st.rank_table.n) and g.dtype == torch.float32
    for want in (as_written, jitted):
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=EST_RTOL)
    for i in range(2):
        np.testing.assert_array_equal(got[i].numpy(),
                                      np.asarray(as_written[i]))
    if spec == "bf16":
        for i in range(2):
            np.testing.assert_array_equal(got[i].numpy(),
                                          np.asarray(jitted[i]))
    else:
        _explained_by_contraction(got, jitted, st, qs, raw)


def test_lookup_scores_and_slack_are_the_reference(int_state):
    """Step-1 scores and slack of stored users, bitwise."""
    _, _, items, _, su, st = int_state
    qs = items[:5]
    want = ref_user_scores_batch(su, jnp.asarray(qs))
    got = Q.user_scores_batch(st.stored_users, torch.from_numpy(qs))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert Q.user_scores_batch(st.users, torch.from_numpy(qs))[1] is None


@pytest.mark.parametrize("spec", SPECS)
def test_bounds_are_contained_in_the_integer_problem(spec):
    """On the integer problem, the quantized bounds contain the f32
    bounds of the same f32 table, cell by cell, for stored users."""
    users, items = _int_problem(12)
    cfg = RefConfig(tau=37, omega=4, s=16)
    rt32 = build_rank_table(jnp.asarray(users), jnp.asarray(items), cfg,
                            jax.random.PRNGKey(6))
    f32 = from_reference(rt32, users, device="cpu")
    spec_ = StorageSpec.parse(spec)
    rt = spec_.pack_table(f32.rank_table.thresholds, f32.rank_table.table,
                          m=f32.rank_table.m)
    qs = torch.from_numpy(items[:16])
    want = Q.bound_ranks_batch(f32.rank_table, f32.users, qs)
    got = Q.bound_ranks_batch(rt, spec_.pack_users(f32.users), qs)
    assert torch.all(got[0] <= want[0] + CONTAIN_TOL)
    assert torch.all(got[1] >= want[1] - CONTAIN_TOL)


def test_slack_on_f32_table_raises_like_reference(int_state):
    _, users, items, _, su, st = int_state
    cfg = RefConfig(tau=37, omega=4, s=16)
    rt32 = build_rank_table(jnp.asarray(users), jnp.asarray(items), cfg,
                            jax.random.PRNGKey(5))
    f32 = from_reference(rt32, device="cpu").rank_table
    qs = torch.from_numpy(items[:2])
    with pytest.raises(ValueError, match="quantized rank table"):
        ref_bound_ranks_batch(rt32, su, jnp.asarray(items[:2]))
    with pytest.raises(ValueError, match="quantized rank table"):
        Q.bound_ranks_batch(f32, st.stored_users, qs)
    with pytest.raises(ValueError, match="quantized rank table"):
        rops.bound_ranks_batched_stored(su, jnp.asarray(items[:2]), rt32)
    with pytest.raises(ValueError, match="quantized rank table"):
        ops.bound_ranks_batched_stored(st.stored_users, qs, f32)


# ----------------------------------------------------------------- fused
@pytest.mark.parametrize("raw", [False, True], ids=["stored", "raw_users"])
@pytest.mark.parametrize("B", [1, 3, 16])
def test_fused_cpu_is_dense_and_the_pallas_run(int_state, B, raw):
    """The plain version of K4/K5 through `ops` equals the dense path
    bitwise, and the reference's Pallas kernel in interpret mode under
    the lookup's rules."""
    spec, _, items, rt, _, st = int_state
    qs = items[np.arange(B) * 11 % items.shape[0]]
    ref_users, users = _users(int_state, raw)
    before = dict(ops.LAUNCHES)
    got = ops.bound_ranks_batched_stored(users, torch.from_numpy(qs),
                                         st.rank_table)
    assert ops.LAUNCHES == before
    dense = Q.bound_ranks_batch(st.rank_table, users, torch.from_numpy(qs))
    for g, d in zip(got, dense):
        assert torch.equal(g, d)
    want = rops.bound_ranks_batched_stored(ref_users, jnp.asarray(qs), rt)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=EST_RTOL)
    if spec == "bf16":
        for i in range(2):
            np.testing.assert_array_equal(got[i].numpy(),
                                          np.asarray(want[i]))
    else:
        _explained_by_contraction(got, want, st, qs, raw)


def test_fused_f32_table_is_k1(int_state):
    """An f32 table with raw users takes K1's path unchanged."""
    _, users, items, _, _, _ = int_state
    cfg = RefConfig(tau=37, omega=4, s=16)
    rt32 = from_reference(build_rank_table(
        jnp.asarray(users), jnp.asarray(items), cfg, jax.random.PRNGKey(5)),
        device="cpu").rank_table
    U, qs = torch.from_numpy(users), torch.from_numpy(items[:4])
    got = ops.bound_ranks_batched_stored(U, qs, rt32)
    want = ops.bound_ranks_batched(U, qs, rt32.thresholds, rt32.table,
                                   m=rt32.m)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------- engine
N, M, D, TAU = 2048, 1024, 32, 64
K, C = 10, 2.0
QIDS = [42, 0, 7, 100, 511, 700, 901, 1023]


@pytest.fixture(scope="module")
def flow():
    """The reference's quickstart flow at f32, bf16 and int8 on one
    embedding set and one Algorithm-1 key, with its exact oracle."""
    users, items = ref_synthetic(jax.random.PRNGKey(0), N, M, D)
    key = jax.random.PRNGKey(1)
    qs = items[jnp.asarray(QIDS)]
    out = {"users": np.array(users), "items": np.array(items),
           "qs": np.array(qs)}
    for spec in SPECS:
        eng = RefEngine.build(users, items,
                              RefConfig(tau=TAU, storage_dtype=spec), key)
        snap = eng.current_snapshot()
        out[spec] = dict(engine=eng, res=eng.query_batch(qs, K, C),
                         stored=snap.stored_users, mem=eng.memory_bytes())
    out["truth"] = [np.asarray(ref_exact_ranks(users, items, qs[b]))
                    for b in range(len(QIDS))]
    out["exact_idx"] = [np.asarray(ref_reverse_k_ranks(users, items, qs[b],
                                                       K)[0])
                        for b in range(len(QIDS))]
    return out


def _metrics(mod, indices, exact_idx, truth):
    acc = [mod.accuracy(np.asarray(i), e, t, C)
           for i, e, t in zip(indices, exact_idx, truth)]
    ratio = [mod.overall_ratio(np.asarray(i), e, t)
             for i, e, t in zip(indices, exact_idx, truth)]
    return acc, ratio


@pytest.mark.parametrize("backend", ["dense", "fused"])
@pytest.mark.parametrize("spec", SPECS)
def test_quickstart_flow_on_reference_state(flow, spec, backend):
    """The reference's packed table carried across: the port's engine
    packs the same users bitwise, counts the same memory, and selects
    the reference's index sets, with equal §5 metrics."""
    ref = flow[spec]
    st = from_reference(ref["engine"].rank_table, flow["users"],
                        flow["items"], stored_users=ref["stored"],
                        device="cpu")
    eng = ReverseKRanksEngine(st.users, st.rank_table,
                              RankTableConfig(tau=TAU, storage_dtype=spec),
                              backend=backend)
    for f in StoredUsers._fields:
        a, b = getattr(eng.stored_users, f), getattr(st.stored_users, f)
        assert (a is None and b is None) or torch.equal(a, b), f
    assert eng.memory_bytes() == ref["mem"]
    qs = torch.from_numpy(flow["qs"])
    res = eng.query_batch(qs, K, C)
    one = eng.query(qs[0], K, C)
    assert torch.equal(one.indices, res.indices[0])

    ref_idx = np.asarray(ref["res"].indices)
    same_sets = [set(a) == set(b) for a, b in zip(res.indices.tolist(),
                                                  ref_idx.tolist())]
    assert all(same_sets), same_sets
    truth = [exact_ranks(st.users, st.items, qs[b]).numpy()
             for b in range(len(QIDS))]
    exact_idx = [reverse_k_ranks(st.users, st.items, qs[b], K)[0].numpy()
                 for b in range(len(QIDS))]
    # exact ranks equal up to the q ∈ P tie (ROADMAP queue 3); equal
    # selections graded by them: equal §5 metrics
    for o, t in zip(truth, flow["truth"]):
        assert np.all((t - o >= 0) & (t - o <= 1))
    ours = _metrics(metrics, res.indices.numpy(), exact_idx, truth)
    theirs = _metrics(ref_metrics, ref_idx, flow["exact_idx"], flow["truth"])
    np.testing.assert_allclose(ours, theirs, rtol=1e-12)


@pytest.fixture(scope="module")
def own_build():
    """The port's own build at f32 on the quickstart's shape (synthetic
    embeddings and samples from torch seeds), and its f32 bounds."""
    users, items = synthetic_embeddings(0, N, M, D, device="cpu")
    cfg = RankTableConfig(tau=TAU)
    g = torch.Generator()
    g.manual_seed(1)
    pos, w = rt_mod.stratified_sample_indices(M, cfg, g)
    f32 = ReverseKRanksEngine.build(users, items, cfg, None, device="cpu",
                                    positions=pos, weights=w)
    qs = items[torch.tensor(QIDS)]
    return users, items, pos, w, f32, qs, f32.query_batch(qs, K, C)


@pytest.mark.parametrize("backend", ["dense", "fused"])
@pytest.mark.parametrize("spec", SPECS)
def test_own_build_contains_f32(own_build, spec, backend):
    """Certified containment on every (query, user), as
    tests/test_storage.py::test_certified_containment holds the
    reference: r↓_spec ≤ r↓_f32 + 1e-4, r↑_spec ≥ r↑_f32 − 1e-4, the
    order statistics bracketed, returned users inside their widened
    interval. The spec engine's pack is `pack_table`/`pack_users` of
    the f32 engine's arrays."""
    users, items, pos, w, f32, qs, want = own_build
    eng = ReverseKRanksEngine.build(
        users, items, RankTableConfig(tau=TAU, storage_dtype=spec), None,
        backend=backend, device="cpu", positions=pos, weights=w)
    packed = StorageSpec.parse(spec).pack_table(
        f32.rank_table.thresholds, f32.rank_table.table, m=M)
    for f in RankTable._fields:
        a, b = getattr(eng.rank_table, f), getattr(packed, f)
        assert a == b if f == "m" else (a is None and b is None) \
            or torch.equal(a, b), f
    res = eng.query_batch(qs, K, C)
    assert torch.all(res.r_lo <= want.r_lo + CONTAIN_TOL)
    assert torch.all(res.r_up >= want.r_up - CONTAIN_TOL)
    assert torch.all(res.R_lo_k <= want.R_lo_k + CONTAIN_TOL)
    assert torch.all(res.R_up_k >= want.R_up_k - CONTAIN_TOL)
    take = lambda a: torch.gather(a, 1, res.indices)
    assert torch.all(take(res.r_lo) - 0.5 - CONTAIN_TOL <= res.est_rank)
    assert torch.all(res.est_rank <= take(res.r_up) + CONTAIN_TOL)
    expect = {"bf16": 2 * N * TAU * 2 + N * D * 2 + N * 4,
              "int8": N * TAU * 2 + 5 * N * 4 + N * D + 2 * N * 4}[spec]
    assert eng.memory_bytes() == expect


def _row_views(rt, su):
    """rt and su with every per-user array a view from row 1 on (at an
    offset from its allocation), and contiguous copies of those views."""
    view = lambda t: None if t is None else t[1:]
    copy = lambda t: None if t is None else t[1:].clone()
    tables = [type(rt)(**{f: (rt.m if f == "m" else fn(getattr(rt, f)))
                          for f in rt._fields}) for fn in (view, copy)]
    users = [type(su)(*(fn(x) for x in su)) for fn in (view, copy)]
    return tables, users


@pytest.mark.parametrize("spec", SPECS)
def test_stored_wrapper_takes_views(spec):
    """The K4/K5 wrapper on views at an offset (stored rows, raw rows and
    every table array from row 1 on) gives bitwise its result on copies
    of the same values. On the CPU this is the plain path; the card's
    kernels are held to the same in test_quant_kernel_staging_on_card."""
    users, items = _int_problem(12)
    U, P = torch.from_numpy(users), torch.from_numpy(items)
    cfg = RankTableConfig(tau=37, omega=4, s=16, storage_dtype=spec)
    g = torch.Generator()
    g.manual_seed(3)
    rt = rt_mod.build_rank_table(U, P, cfg, g)
    (rt_v, rt_c), (su_v, su_c) = _row_views(rt, cfg.storage.pack_users(U))
    assert rt_v.table.data_ptr() != rt_c.table.data_ptr()
    for u_v, u_c in ((su_v, su_c), (U[1:], U[1:].clone())):
        for B in (1, 3, 16):
            qs = P[:B].contiguous()
            got = ops.bound_ranks_batched_stored(u_v, qs, rt_v)
            want = ops.bound_ranks_batched_stored(u_c, qs, rt_c)
            for g_, w_ in zip(got, want):
                assert torch.equal(g_, w_)


# ------------------------------------------------------------------ card
@pytest.mark.cuda
@pytest.mark.parametrize("spec", SPECS)
def test_quant_kernel_matches_plain_on_card(spec):
    """K4 (bf16) and K5 (int8) against their plain version on the card,
    on integer inputs (exact scores and slacks in any order), at ragged
    shapes, stored and raw users. Run on a machine with a GPU:
    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_storage.py"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    users, items = _int_problem(9, n=1000, m=777, d=37)
    for tau in (37, 777):
        cfg = RankTableConfig(tau=tau, omega=4, s=16, storage_dtype=spec)
        U, P = torch.from_numpy(users).to(dev), torch.from_numpy(items).to(dev)
        g = torch.Generator(device=dev)
        g.manual_seed(tau)
        rt = rt_mod.build_rank_table(U, P, cfg, g)
        su = cfg.storage.pack_users(U)
        for B in (1, 2, 3, 6, 16, 19):
            qs = P[:B].contiguous()
            for u in (su, U):
                rows, uscale, uslack = ops.stored_parts(u, spec)
                got = ops.bound_ranks_batched_stored(u, qs, rt)
                want = ref.ref_bound_ranks_stored(rows, uscale, uslack, qs,
                                                  Q.query_l1(qs), rt)
                assert torch.equal(got[0], want[0].T)
                assert torch.equal(got[1], want[1].T)
                torch.testing.assert_close(got[2], want[2].T,
                                           rtol=EST_RTOL, atol=0)


# K4/K5/K7 stage tiles of rows through a shared-memory ring by bulk
# copies; these cases drive the ring's edges on the card: a launch with
# fewer rows than a tile and one row past a tile (the tile size read from
# the launcher), rows whose bytes are not a multiple of 16 (d = 37), an
# odd τ, a τ whose thresholds rows do not fit a stage (searched in global
# memory instead), Qᵀ streamed (d = 1,031), K7 under a row map whose
# entries start off 16 bytes, with a tail tile and duplicate ids, and a
# view at an offset, whose every staged array starts off 16 bytes and
# which must give bitwise the outputs of the same call on a copy.
STAGING_CASES = ("n_below_tile", "n_past_tile", "d37", "tau777",
                 "tau_past_stage", "d1031", "k7_tail_dups", "unaligned_view")


def _card_table(spec, n, d, tau, m, seed):
    """Integer users/items on the card and a `spec` rank table built
    from them; (users, items, rt, stored users)."""
    dev = torch.device("cuda")
    users, items = _int_problem(seed, n=n, m=m, d=d)
    U, P = torch.from_numpy(users).to(dev), torch.from_numpy(items).to(dev)
    cfg = RankTableConfig(tau=tau, omega=4, s=16, storage_dtype=spec)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return U, P, rt_mod.build_rank_table(U, P, cfg, g), \
        cfg.storage.pack_users(U)


def _wide_tau_table(spec, n, tau, m, seed):
    """A `spec` table whose rows are τ sorted integer thresholds and a
    non-increasing integer table, packed from f32 on the card."""
    rng = np.random.default_rng(seed)
    thr = np.sort(rng.integers(-120, 121, (n, tau)), axis=1)
    tab = np.sort(rng.integers(1, m + 2, (n, tau)), axis=1)[:, ::-1]
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)) \
        .cuda()
    cfg = RankTableConfig(tau=tau, storage_dtype=spec)
    return cfg.storage.pack_table(to(thr), to(tab), m=m)


def _assert_plain(u, qs, rt, spec):
    """K4/K5 on integer inputs: bounds bitwise the plain version's, est
    within 1e-5 relative."""
    rows, uscale, uslack = ops.stored_parts(u, spec)
    got = ops.bound_ranks_batched_stored(u, qs, rt)
    want = ref.ref_bound_ranks_stored(rows, uscale, uslack, qs,
                                      Q.query_l1(qs), rt)
    assert torch.equal(got[0], want[0].T)
    assert torch.equal(got[1], want[1].T)
    torch.testing.assert_close(got[2], want[2].T, rtol=EST_RTOL, atol=0)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("case", STAGING_CASES)
@pytest.mark.parametrize("spec", SPECS)
def test_quant_kernel_staging_on_card(spec, case):
    """K4 (bf16) and K5 (int8), and K7 behind a row map, at the edges of
    their shared-memory ring, on integer inputs: bounds bitwise their
    plain version's (est 1e-5), K7's kept rows bitwise K4's / K5's. Run
    on a machine with a GPU:
    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_storage.py"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.core import pruning
    from repro_torch.kernels import user_scores
    if case in ("n_below_tile", "n_past_tile"):
        U, P, rt, su = _card_table(spec, 200, 37, 37, 300, 21)
        for B in (1, 16):
            qs = P[:B].contiguous()
            for u, raw in ((su, False), (U, True)):
                T = user_scores.quant_launch_config(spec, raw, B, 37,
                                                    37)["tile_rows"]
                n = max(1, T - 3) if case == "n_below_tile" else T + 1
                keep = torch.arange(n, device="cuda")
                uu = U[:n] if raw else su.take_rows(keep)
                _assert_plain(uu, qs, rt.take_rows(keep), spec)
        return
    if case == "unaligned_view":
        U, P, rt, su = _card_table(spec, 300, 37, 37, 300, 22)
        (rt_v, rt_c), (su_v, su_c) = _row_views(rt, su)
        for u_v, u_c in ((su_v, su_c), (U[1:], U[1:].clone())):
            for B in (1, 3, 16):
                qs = P[:B].contiguous()
                got = ops.bound_ranks_batched_stored(u_v, qs, rt_v)
                want = ops.bound_ranks_batched_stored(u_c, qs, rt_c)
                for g_, w_ in zip(got, want):
                    assert torch.equal(g_, w_)
                _assert_plain(u_v, qs, rt_v, spec)
        return
    if case == "tau_past_stage":
        tau, n, d = 4000, 300, 37
        U, P, _, _ = _card_table(spec, n, d, 37, 300, 23)
        rt = _wide_tau_table(spec, n, tau, 300, 23)
        su = RankTableConfig(storage_dtype=spec).storage.pack_users(U)
        if spec == "bf16":
            for B in (1, 16):
                cfg = user_scores.quant_launch_config(spec, False, B, d, tau)
                assert cfg["thresholds_staged"] == 0
        for B in (1, 3, 16):
            for u in (su, U):
                _assert_plain(u, P[:B].contiguous(), rt, spec)
        return
    n, d, tau, m = {"d37": (1000, 37, 37, 777), "tau777": (300, 24, 777, 777),
                    "d1031": (300, 1031, 33, 300),
                    "k7_tail_dups": (1000, 37, 37, 777)}[case]
    U, P, rt, su = _card_table(spec, n, d, tau, m, 24)
    for B in (1, 2, 3, 16, 19):
        qs = P[:B].contiguous()
        for u in (su, U):
            full = _assert_plain(u, qs, rt, spec)
            if case != "k7_tail_dups":
                continue
            for bn in (256, 100):
                nblk = -(-n // bn)
                for ids in ((nblk - 1, 0, 3, 3), (nblk - 1,), (2, 2, 1)):
                    t = torch.tensor(ids, dtype=torch.int32, device="cuda")
                    got = ops.bound_ranks_batched_pruned_stored(
                        u, qs, rt, t, block_n=bn)
                    ridx = pruning.row_indices(t, bn).long()
                    past = ridx >= n
                    for g_, f_ in zip(got, full):
                        assert torch.equal(g_[:, ~past], f_[:, ridx[~past]])
                        assert bool((g_[:, past] == float(rt.m + 2)).all())
