"""The port's block pruning (`repro_torch.core.pruning`, the pruned backend,
K6/K7's plain versions) against the JAX reference, one stage at a time,
each stage fed the reference's own inputs carried across through numpy,
so that drift in one stage cannot hide in the next:

  summary   `build_block_summary`: the box and the thr/tab envelopes
            bitwise at f32 and bf16, at int8 bitwise the reference run op
            by op and, against the jitted reference, equal to XLA's
            contracted value wherever they differ; the cone fields as
            certificates (sqrt and normalization order differ);
  phase A   on the reference's summary: keep and R̂ bitwise on integer
            inputs without cones (every box product exact); with cones,
            the keep mask is sound and differs from the reference's only
            where a block's bound is within 1e-5 of R̂;
  phase B   `bucket_*`, `row_indices` exactly; `finish_compacted` and
            `materialize` bitwise on the reference's compacted arrays;
  layout    `kmeans_layout`'s structure, and the reference's permutation
            and `user_remap` given the reference's initial centers;
  end to end `pruned:dense` and `pruned:fused` select bitwise the indices
            of their own inner full scan at every spec and B ∈ {1, 16},
            and the reference's `pruned:dense` indices on integer inputs.

Also the two faults this slice closes: ‖q‖₁ is bitwise the same for a
query at any B, and no kernel wrapper refuses a d that the reference
accepts. Tests of the CUDA kernels carry the `cuda` marker.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backends as RBK
from repro.core import pruning as RP
from repro.core.engine import ReverseKRanksEngine as RefEngine
from repro.core.rank_table import build_rank_table
from repro.core.types import RankTableConfig as RefConfig
from repro_torch.convert import from_reference, summary_from_reference
from repro_torch.core import backends as BK
from repro_torch.core import pruning as P
from repro_torch.core import query as Q
from repro_torch.core.engine import ReverseKRanksEngine
from repro_torch.core.types import RankTableConfig, StoredUsers
from repro_torch.kernels import _build, ops, ref

K, BS = 7, 64
N, M, D, NCL = 2048, 512, 16, 16
SPECS = ("f32", "bf16", "int8")
REF_SPEC = {"f32": "float32", "bf16": "bfloat16", "int8": "int8"}
EST_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads, so torch does not starve the timing-sensitive
    tests that share the run."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def clustered(seed, n=N, m=M, d=D, n_clusters=NCL, spread=0.1,
              integer=False, shuffle=False):
    """Cluster-contiguous users (blocks are coherent, phase A prunes) and
    items near the same centers, from numpy; integer-valued on request
    (every dot product then exact in any order)."""
    rng = np.random.default_rng(seed)
    assign = np.arange(n) * n_clusters // n
    if integer:
        centers = rng.integers(-8, 9, (n_clusters, d))
        users = centers[assign] + rng.integers(-1, 2, (n, d))
        items = (centers[rng.integers(0, n_clusters, m)]
                 + rng.integers(-1, 2, (m, d)))
    else:
        centers = rng.standard_normal((n_clusters, d)) * 2.0
        users = centers[assign] + spread * rng.standard_normal((n, d))
        items = (centers[rng.integers(0, n_clusters, m)]
                 + spread * rng.standard_normal((m, d)))
    if shuffle:
        users = users[rng.permutation(n)]
    return users.astype(np.float32), items.astype(np.float32)


def off_grid(items, B, seed=7, rel=1e-4):
    """B item queries with a small relative jitter, from numpy."""
    rng = np.random.default_rng(seed)
    base = items[(18 + np.arange(B) * 17) % items.shape[0]]
    return (base * (1.0 + rel * rng.standard_normal(base.shape))
            ).astype(np.float32)


def _state(users, items, spec, seed=1, tau=16):
    """The reference's table (and stored users) on (users, items) at
    `spec`, and the same state carried across to the port."""
    cfg = RefConfig(tau=tau, omega=4, s=8, storage_dtype=REF_SPEC[spec])
    rt = build_rank_table(jnp.asarray(users), jnp.asarray(items), cfg,
                          jax.random.PRNGKey(seed))
    su = cfg.storage.pack_users(jnp.asarray(users))
    st = from_reference(rt, users, items, stored_users=su, device="cpu")
    ref_users = jnp.asarray(users) if su is None else su
    port_users = st.users if su is None else st.stored_users
    return rt, ref_users, st.rank_table, port_users


@pytest.fixture(scope="module")
def problem():
    return clustered(0)


@pytest.fixture(scope="module", params=SPECS)
def spec_state(request, problem):
    users, items = problem
    return (request.param,) + _state(users, items, request.param)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# -------------------------------------------------------------- summary
BITWISE_FIELDS = ("dim_min", "dim_max", "thr_min", "thr_max", "tab_min",
                  "tab_max", "rows")
CONE_FIELDS = ("norm_min", "norm_max", "mu", "cos_r")


@pytest.mark.parametrize("spec", ["f32", "bf16"])
@pytest.mark.parametrize("n", [N, 1000])
def test_summary_is_bitwise_the_reference(problem, spec, n):
    """Box and envelopes bitwise at f32 and bf16, with a partial tail
    block at n = 1000; rows, m, user_slack and score_eps too."""
    users, items = problem
    rt, ru, prt, pu = _state(users[:n], items, spec)
    want = RP.build_block_summary(ru, rt, block_size=BS)
    got = P.build_block_summary(pu, prt, block_size=BS)
    for f in BITWISE_FIELDS + ("user_slack", "score_eps"):
        w, g = getattr(want, f), getattr(got, f)
        if w is None:
            assert g is None, f
            continue
        np.testing.assert_array_equal(_np(g), np.asarray(w), f)
    assert got.m == int(want.m) and got.n_blocks == -(-n // BS)
    assert int(got.rows.sum()) == n


def _contracted_envelopes(prt, op):
    """The int8 envelope rows as XLA contracts them under jit: each of
    code·sc + off and thr32 ∓ half·sc may be one fused multiply-add.
    Returns the candidate per-block envelopes, float64 FMAs rounded to
    f32 (exact here: an 8-bit code times an f32 scale plus an f32 offset
    fits in 53 bits)."""
    half = np.float32(0.5 + 1e-4)
    out = {}
    for name, codes, sc, off in (
            ("thr", prt.thresholds, prt.thr_scale, prt.thr_off),
            ("tab", prt.table, prt.tab_scale, prt.tab_off)):
        c = codes.numpy().astype(np.float64)
        s, o = sc.numpy(), off.numpy()
        deq = {"plain": (c.astype(np.float32) * s + o).astype(np.float32),
               "fma": (c * s.astype(np.float64)
                       + o.astype(np.float64)).astype(np.float32)}
        w = (half * s).astype(np.float32)
        for dk, x in deq.items():
            for sign, side in ((-1.0, "lo"), (1.0, "hi")):
                rows = {"plain": (x + np.float32(sign) * w).astype(
                            np.float32),
                        "fma": (x.astype(np.float64) + sign
                                * half.astype(np.float64)
                                * s.astype(np.float64)).astype(np.float32)}
                for r in rows.values():
                    out.setdefault((name, side), []).append(
                        _np(P._per_block(torch.from_numpy(r), BS, op(side))))
    return out


def test_summary_int8_is_the_reference_as_written_and_contracted(problem):
    """int8 envelopes: bitwise the reference run op by op; against the
    jitted reference, every differing cell equals one of XLA's
    contractions of the dequantization and the widening."""
    users, items = problem
    rt, ru, prt, pu = _state(users, items, "int8")
    got = P.build_block_summary(pu, prt, block_size=BS)
    with jax.disable_jit():
        written = RP.build_block_summary(ru, rt, block_size=BS)
    jitted = RP.build_block_summary(ru, rt, block_size=BS)
    for f in BITWISE_FIELDS + ("user_slack", "score_eps"):
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      np.asarray(getattr(written, f)), f)
    cands = _contracted_envelopes(
        prt, lambda side: "amin" if side == "lo" else "amax")
    for f, key in (("thr_min", ("thr", "lo")), ("thr_max", ("thr", "hi")),
                   ("tab_min", ("tab", "lo")), ("tab_max", ("tab", "hi"))):
        g, w = _np(getattr(got, f)), np.asarray(getattr(jitted, f))
        differ = g != w
        ok = np.zeros_like(differ)
        for c in cands[key]:
            ok |= c == w
        assert np.all(ok[differ]), f


@pytest.mark.parametrize("spec", SPECS)
def test_cone_fields_are_certificates(problem, spec):
    """norm band ∋ every member's float64 ‖u‖; cos_r ≤ every member's
    float64 û·μ̂; μ̂ unit to 1e-6 or exactly 0; each field within 1e-5 of
    the reference's."""
    users, items = problem
    rt, ru, prt, pu = _state(users, items, spec)
    got = P.build_block_summary(pu, prt, block_size=BS)
    want = RP.build_block_summary(ru, rt, block_size=BS)
    u = (pu.rows.to(torch.float64) * (1.0 if pu.scale is None
                                      else pu.scale.to(torch.float64))
         if isinstance(pu, StoredUsers) else pu.to(torch.float64)).numpy()
    norms = np.linalg.norm(u, axis=1)
    uhat = u / np.maximum(norms, 1e-300)[:, None]
    mu = got.mu.numpy().astype(np.float64)
    mu_n = np.linalg.norm(mu, axis=1)
    assert np.all((np.abs(mu_n - 1.0) < 1e-6) | (mu_n == 0.0))
    for blk in range(got.n_blocks):
        rows = slice(blk * BS, min((blk + 1) * BS, N))
        assert got.norm_min[blk, 0].item() <= norms[rows].min()
        assert got.norm_max[blk, 0].item() >= norms[rows].max()
        assert got.cos_r[blk, 0].item() <= (uhat[rows] @ mu[blk]).min()
    for f in CONE_FIELDS:
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-5, err_msg=f)


# -------------------------------------------------------------- phase A
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("spec", SPECS)
def test_phase_a_bitwise_on_integer_inputs(spec, B):
    """Without cones, on integer users and queries every box product is
    exact: fed the reference's summary, keep and R̂ are bitwise its."""
    users, items = clustered(5, integer=True)
    rt, ru, prt, pu = _state(users, items, spec)
    summ = RP.build_block_summary(ru, rt, block_size=BS, with_cones=False)
    qs = items[np.arange(B) * 29 % M]
    keep_w, rhat_w = RP.phase_a(summ, jnp.asarray(qs), k=K, block_size=BS)
    keep_g, rhat_g = P.phase_a(summary_from_reference(summ, device="cpu"),
                               torch.from_numpy(qs), k=K)
    np.testing.assert_array_equal(keep_g.numpy(), np.asarray(keep_w))
    np.testing.assert_array_equal(rhat_g.numpy(), np.asarray(rhat_w))


def _full_scan_bounds(prt, pu, qs):
    scores, slack = Q.user_scores_batch(pu, qs)
    return Q.lookup_bounds_batch(prt, scores, slack)        # (n, B) each


def test_phase_a_with_cones_is_sound(spec_state):
    """With cones (float inputs): every block holding a user whose
    full-scan r↓ ≤ R↑_k is kept, for each query; where the port's keep
    differs from the reference's (fed the same summary), the block's r↓
    bound is within 1e-5 relative of R̂."""
    spec, rt, ru, prt, pu = spec_state
    _, items = clustered(0)
    qs = off_grid(items, 8)
    summ = RP.build_block_summary(ru, rt, block_size=BS)
    keep_w, _ = RP.phase_a(summ, jnp.asarray(qs), k=K, block_size=BS)
    ps = summary_from_reference(summ, device="cpu")
    keep, r_hat = P.phase_a(ps, torch.from_numpy(qs), k=K)
    r_lo, r_up, _ = _full_scan_bounds(prt, pu, torch.from_numpy(qs))
    R_up_k = torch.topk(r_up, K, dim=0, largest=False).values[-1]   # (B,)
    assert bool((r_hat >= R_up_k).all())
    need = (r_lo <= R_up_k[None, :])                         # (n, B)
    blk = torch.arange(N) // BS
    for b in range(qs.shape[0]):
        needed = torch.unique(blk[need[:, b]])
        assert bool(keep[b, needed].all()), b
    lo_env, _ = P._envelope_bounds(ps, torch.from_numpy(qs))  # (nb, B)
    differ = keep.numpy() != np.asarray(keep_w)
    rel = np.abs(lo_env.T.numpy() - r_hat.numpy()[:, None]) \
        / np.abs(r_hat.numpy()[:, None])
    assert np.all(rel[differ] <= 1e-5)


def test_envelopes_certify_members(problem):
    """Every user's (r↓, r↑) lies inside its block's envelope bounds
    (the port's own summary)."""
    users, items = problem
    _, _, prt, pu = _state(users, items, "f32")
    summ = P.build_block_summary(pu, prt, block_size=BS)
    qs = torch.from_numpy(off_grid(items, 8))
    r_lo, r_up, _ = _full_scan_bounds(prt, pu, qs)
    lo_env, up_env = P._envelope_bounds(summ, qs)
    for blk in range(summ.n_blocks):
        rows = slice(blk * BS, (blk + 1) * BS)
        assert bool((lo_env[blk] <= r_lo[rows].min(dim=0).values).all())
        assert bool((up_env[blk] >= r_up[rows].max(dim=0).values).all())


def test_rhat_bounds_true_Rupk(spec_state):
    spec, rt, ru, prt, pu = spec_state
    _, items = clustered(0)
    qs = torch.from_numpy(off_grid(items, 8))
    _, r_hat = P.phase_a(P.build_block_summary(pu, prt, block_size=BS), qs,
                         k=K)
    _, r_up, _ = _full_scan_bounds(prt, pu, qs)
    assert bool((r_hat >= torch.topk(r_up, K, dim=0,
                                     largest=False).values[-1]).all())


def test_cones_tighter_than_box(problem):
    """cone ∩ box is never looser than the box alone, and tighter on
    average on clustered blocks."""
    users, items = problem
    _, _, prt, pu = _state(users, items, "f32")
    box = P.build_block_summary(pu, prt, block_size=BS, with_cones=False)
    cone = P.build_block_summary(pu, prt, block_size=BS)
    assert box.norm_min is None and cone.norm_min is not None
    qs = torch.from_numpy(off_grid(items, 8))
    lo_b, up_b = P._envelope_bounds(box, qs)
    lo_c, up_c = P._envelope_bounds(cone, qs)
    assert bool((lo_c >= lo_b).all()) and bool((up_c <= up_b).all())
    assert float((up_c - lo_c).mean()) < float((up_b - lo_b).mean())


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("block_size", [32, 64])
def test_cone_band_containment_every_spec(spec, block_size):
    """Cone + band envelopes bracket every member's certified (r↓, r↑) at
    every spec, on blocks with exactly-zero and antipodal rows (the
    degenerate branches of the cone)."""
    rng = np.random.default_rng(block_size)
    users = (3.0 * rng.standard_normal((192, 8))).astype(np.float32)
    users[:2] = 0.0
    users[2] = -users[3]
    items = (3.0 * rng.standard_normal((96, 8))).astype(np.float32)
    _, _, prt, pu = _state(users, items, spec, tau=8)
    summ = P.build_block_summary(pu, prt, block_size=block_size)
    qs = torch.from_numpy(off_grid(items, 4, rel=1e-3))
    r_lo, r_up, _ = _full_scan_bounds(prt, pu, qs)
    lo_env, up_env = P._envelope_bounds(summ, qs)
    for blk in range(summ.n_blocks):
        rows = slice(blk * block_size, (blk + 1) * block_size)
        assert bool((lo_env[blk] <= r_lo[rows].min(dim=0).values).all())
        assert bool((up_env[blk] >= r_up[rows].max(dim=0).values).all())


# -------------------------------------------------------------- phase B
@pytest.mark.parametrize("n_blocks", [1, 7, 32, 100, 1876])
def test_bucketing_and_row_indices_are_the_reference(n_blocks):
    rng = np.random.default_rng(n_blocks)
    for count in sorted({0, 1, 2, n_blocks // 3, n_blocks - 1, n_blocks}
                        & set(range(n_blocks + 1))):
        for min_blocks in (1, 3):
            assert P.bucket_width(count, n_blocks=n_blocks,
                                  min_blocks=min_blocks) == RP.bucket_width(
                count, n_blocks=n_blocks, min_blocks=min_blocks)
            kept = np.sort(rng.choice(n_blocks, size=count, replace=False))
            want = RP.bucket_blocks(kept, n_blocks=n_blocks,
                                    min_blocks=min_blocks)
            got = P.bucket_blocks(kept, n_blocks=n_blocks,
                                  min_blocks=min_blocks)
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(
                P.row_indices(torch.from_numpy(got), BS).numpy(),
                np.asarray(RP.row_indices(jnp.asarray(want), BS)))


@pytest.mark.parametrize("c", [1.0, 32.0])
@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("spec", SPECS)
def test_finish_and_materialize_bitwise_on_reference_arrays(spec, B, c):
    """Fed the reference's compacted phase-B arrays (with padding tiles
    and a partial tail block), the port's selection and materialization
    equal the reference's in every field."""
    users, items = clustered(3, n=1000)
    rt, ru, _, _ = _state(users, items, spec)
    qs = jnp.asarray(off_grid(items, B))
    summ = RP.build_block_summary(ru, rt, block_size=BS)
    keep, _ = RP.phase_a(summ, qs, k=K, block_size=BS)
    keep_np = np.asarray(keep)
    union = np.flatnonzero(keep_np.any(axis=0))
    ids = RP.bucket_blocks(union, n_blocks=summ.n_blocks, min_blocks=1)
    ids = np.concatenate([ids, ids[:2]])          # padding tiles
    valid = np.arange(ids.size) < union.size
    r_lo, r_up, est = RP._gathered_bounds(rt, ru, qs, jnp.asarray(ids), BS)
    want = RP.finish_compacted(r_lo, r_up, est, jnp.asarray(ids),
                               jnp.asarray(valid), keep, rt.m, K, c, n=1000,
                               block_size=BS)
    t = lambda a: torch.from_numpy(np.array(a))
    got = P.finish_compacted(t(r_lo), t(r_up), t(est), t(ids), t(valid),
                             t(keep_np), int(rt.m), K, c, 1000, BS)
    for f in got._fields:
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)
    sentinel = float(int(rt.m) + 2)
    for vals in (r_lo, r_up):
        np.testing.assert_array_equal(
            P.materialize(t(vals), t(ids), t(keep_np), 1000, sentinel,
                          BS).numpy(),
            np.asarray(RP.materialize(vals, jnp.asarray(ids), keep, 1000,
                                      sentinel, BS)))


# --------------------------------------------------------------- layout
def _ref_init_rows(n, block_size, n_clusters=None, seed=0):
    """The initial centers `repro.core.pruning.kmeans_layout` draws."""
    K_ = int(n_clusters) if n_clusters else int(
        np.clip(n // (4 * block_size), 2, 128))
    K_ = min(K_, n)
    return torch.from_numpy(np.array(jax.random.choice(
        jax.random.PRNGKey(seed), n, shape=(K_,), replace=False)))


def _check_layout(users, perm, iters=8, init_rows=None):
    """perm groups the k-means clusters contiguously, each ordered by
    (distance to its center, row id)."""
    u = torch.from_numpy(users)
    n = u.shape[0]
    assert perm.dtype == torch.int64
    assert torch.equal(torch.sort(perm).values, torch.arange(n))
    centers = u[init_rows]
    for _ in range(iters):
        assign, centers = P._kmeans_step(u, centers)
    d2 = torch.sum((u - centers[assign]) ** 2, dim=1)
    want = np.lexsort((np.arange(n), d2.numpy(), assign.numpy()))
    np.testing.assert_array_equal(perm.numpy(), want)
    a = assign[perm].numpy()
    assert np.all(np.diff(a) >= 0)


@pytest.mark.parametrize("n_clusters", [None, 32])
def test_kmeans_layout_structure(n_clusters):
    users, _ = clustered(21, shuffle=True)
    init = _ref_init_rows(N, BS, n_clusters)
    perm = P.kmeans_layout(torch.from_numpy(users), block_size=BS,
                           init_rows=init)
    _check_layout(users, perm, init_rows=init)
    drawn = P.kmeans_layout(torch.from_numpy(users), block_size=BS,
                            n_clusters=n_clusters)
    assert torch.equal(drawn, P.kmeans_layout(torch.from_numpy(users),
                                              block_size=BS,
                                              n_clusters=n_clusters))
    assert P.kmeans_layout(torch.from_numpy(users[:BS]),
                           block_size=BS) is None


def test_kmeans_layout_is_the_reference_on_separated_clusters():
    """Well-separated clusters (no assignment near a tie), the
    reference's initial centers: the reference's permutation exactly."""
    users, _ = clustered(21, shuffle=True, spread=0.05)
    init = _ref_init_rows(N, BS)
    want = RP.kmeans_layout(jnp.asarray(users), block_size=BS)
    got = P.kmeans_layout(torch.from_numpy(users), block_size=BS,
                          init_rows=init)
    np.testing.assert_array_equal(got.numpy(), want)


def test_kmeans_layout_tightens_envelopes():
    users, items = clustered(21, shuffle=True)
    _, _, prt, pu = _state(users, items, "f32")
    perm = P.kmeans_layout(pu, block_size=BS, n_clusters=32)
    s_raw = P.build_block_summary(pu, prt, block_size=BS)
    s_re = P.build_block_summary(pu[perm], prt.take_rows(perm),
                                 block_size=BS)
    qs = torch.from_numpy(off_grid(items, 8))
    lo_raw, up_raw = P._envelope_bounds(s_raw, qs)
    lo_re, up_re = P._envelope_bounds(s_re, qs)
    assert float((up_re - lo_re).mean()) < float((up_raw - lo_raw).mean())


def test_cluster_reorder_remap_is_the_reference():
    """build(cluster_reorder=True): the permuted users, and `user_remap`
    equal to the reference's, given the reference's initial centers."""
    users, items = clustered(23, shuffle=True, spread=0.05)
    cfg = RefConfig(tau=16, omega=4, s=8)
    ref_eng = RefEngine.build(jnp.asarray(users), jnp.asarray(items), cfg,
                              jax.random.PRNGKey(1), cluster_reorder=True)
    want = ref_eng.current_snapshot().user_remap
    eng = ReverseKRanksEngine.build(
        torch.from_numpy(users), torch.from_numpy(items),
        RankTableConfig(tau=16, omega=4, s=8), 1, device="cpu",
        cluster_reorder=True,
        kmeans_init=_ref_init_rows(N, RP.DEFAULT_BLOCK))
    np.testing.assert_array_equal(eng.user_remap.numpy(), want)
    np.testing.assert_array_equal(eng.users.numpy(),
                                  np.asarray(ref_eng.users))
    plain = ReverseKRanksEngine.build(
        torch.from_numpy(users), torch.from_numpy(items),
        RankTableConfig(tau=16, omega=4, s=8), 1, device="cpu")
    assert plain.user_remap is None


def test_identity_layout_publishes_no_remap():
    """Users already in k-means order: no remap, rows unchanged."""
    users, items = clustered(23, shuffle=True, spread=0.05)
    init = _ref_init_rows(N, P.DEFAULT_BLOCK)
    perm = P.kmeans_layout(torch.from_numpy(users), init_rows=init)
    ordered = torch.from_numpy(users)[perm]
    eng = ReverseKRanksEngine.build(
        ordered, torch.from_numpy(items), RankTableConfig(tau=16, omega=4,
                                                          s=8), 1,
        device="cpu", cluster_reorder=True,
        kmeans_init=torch.argsort(perm)[init])
    assert eng.user_remap is None and torch.equal(eng.users, ordered)


# ------------------------------------------------------------ end to end
def _pruned(users, rt, cfg, inner, **knobs):
    bk = BK.PrunedBackend(inner, block_size=BS, **knobs)
    return ReverseKRanksEngine(users, rt, cfg, backend=bk)


def _own_engines(spec, users, items, inner, **knobs):
    """The port's own build at `spec` (CPU), its pruned twin and its
    inner full scan on the same state."""
    cfg = RankTableConfig(tau=16, omega=4, s=8, storage_dtype=spec)
    full = ReverseKRanksEngine.build(torch.from_numpy(users),
                                     torch.from_numpy(items), cfg, 1,
                                     backend=inner, device="cpu")
    return full, _pruned(full.users, full.rank_table, cfg, inner, **knobs)


def _same_selection(got, want):
    assert torch.equal(got.indices, want.indices)
    torch.testing.assert_close(got.est_rank, want.est_rank, rtol=EST_RTOL,
                               atol=1e-4)
    assert torch.equal(got.R_lo_k, want.R_lo_k)
    assert torch.equal(got.R_up_k, want.R_up_k)
    assert torch.equal(got.guaranteed, want.guaranteed)


@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("inner", ["dense", "fused"])
@pytest.mark.parametrize("spec", SPECS)
def test_pruned_selects_the_inner_full_scan(problem, spec, inner, B):
    """Bitwise the indices of the inner full scan on the same state, with
    real skipping (clustered users, queries from one cluster)."""
    users, items = problem
    full, eng = _own_engines(spec, users, items, inner)
    rng = np.random.default_rng(5)
    qs = torch.from_numpy((items[:1] * (1.0 + 1e-4 * rng.standard_normal(
        (B, D)))).astype(np.float32))
    want = full.query_batch(qs, K, 1.0)
    got = eng.query_batch(qs, K, 1.0)
    _same_selection(got, want)
    st = eng._backend.stats
    assert st.fallback == "" and st.skip_rate > 0 and st.n_blocks == N // BS
    # the CPU product is not bitwise across B: est to 1e-5 (on the card
    # the kernels are, and chip_smoke.py holds them bitwise)
    one = eng.query(qs[0], K, 1.0)
    assert torch.equal(one.indices, got.indices[0])
    torch.testing.assert_close(one.est_rank, got.est_rank[0], rtol=EST_RTOL,
                               atol=1e-4)


@pytest.mark.parametrize("regime", ["guaranteed", "non_guaranteed"])
@pytest.mark.parametrize("inner", ["dense", "fused"])
def test_pruned_matches_inner_both_regimes(problem, inner, regime):
    users, items = problem
    full, eng = _own_engines("f32", users, items, inner)
    c = 32.0 if regime == "guaranteed" else 1.0
    qs = torch.from_numpy(off_grid(items, 16))
    want = full.query_batch(qs, K, c)
    _same_selection(eng.query_batch(qs, K, c), want)


def test_iid_users_fall_back_to_the_full_scan():
    """i.i.d. users: every block looks alike, phase A keeps (nearly)
    everything and the full scan runs; forcing phase B is still exact."""
    rng = np.random.default_rng(9)
    users = rng.standard_normal((1024, D)).astype(np.float32)
    items = rng.standard_normal((256, D)).astype(np.float32)
    full, eng = _own_engines("f32", users, items, "dense")
    qs = torch.from_numpy(off_grid(items, 8))
    want = full.query_batch(qs, K, 1.0)
    _same_selection(eng.query_batch(qs, K, 1.0), want)
    st = eng._backend.stats
    assert st.fallback == "dense" and st.kept_per_query > 0.5
    forced = _pruned(full.users, full.rank_table, full.config, "dense",
                     max_union_frac=1.0)
    _same_selection(forced.query_batch(qs, K, 1.0), want)
    assert forced._backend.stats.fallback == ""


def test_tail_block_parity():
    """n not a multiple of the block size: the partial tail block counts
    its real rows, and the pruned selection is still the full scan's."""
    users, items = clustered(3, n=1000, m=256)
    for inner in ("dense", "fused"):
        full, eng = _own_engines("f32", users, items, inner,
                                 max_union_frac=1.0)
        summ = eng._backend.summary_for(full.rank_table, full.users)
        assert int(summ.rows.sum()) == 1000
        assert int(summ.rows[-1]) == 1000 - 15 * BS
        qs = torch.from_numpy(off_grid(items, 4))
        _same_selection(eng.query_batch(qs, K, 1.0),
                        full.query_batch(qs, K, 1.0))


@pytest.mark.parametrize("B", [1, 16])
def test_pruned_dense_is_the_reference_on_integer_inputs(B):
    """On integer inputs at f32, the port's pruned:dense selects the
    reference's pruned:dense indices on the same table."""
    users, items = clustered(5, integer=True)
    rt, ru, prt, pu = _state(users, items, "f32")
    ref_eng = RefEngine(users=ru, rank_table=rt,
                        config=RefConfig(tau=16, omega=4, s=8),
                        backend="pruned:dense")
    ref_eng._backend.block_size = BS
    qs = (items[np.arange(B) * 29 % M] + 0.5).astype(np.float32)
    want = ref_eng.query_batch(jnp.asarray(qs), k=K, c=1.0)
    eng = _pruned(pu, prt, RankTableConfig(tau=16, omega=4, s=8), "dense")
    got = eng.query_batch(torch.from_numpy(qs), K, 1.0)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    assert eng._backend.stats.kept_union == ref_eng._backend.stats.kept_union
    assert eng._backend.stats.fallback == ref_eng._backend.stats.fallback


@pytest.mark.parametrize("inner", ["dense", "fused"])
def test_reordered_parity(inner):
    """build(cluster_reorder=True): bitwise the inner full scan on the same
    reordered state, and through the remap the same users as an engine
    that never reordered (exact thresholds: est is continuous, so
    clustered Gaussian users do not tie across layouts)."""
    users, items = clustered(23, shuffle=True)
    cfg = RankTableConfig(tau=64, omega=4, s=M // 4, threshold_mode="exact")
    eng = ReverseKRanksEngine.build(
        torch.from_numpy(users), torch.from_numpy(items), cfg, 1,
        backend=BK.PrunedBackend(inner, block_size=BS), device="cpu",
        cluster_reorder=True)
    raw = ReverseKRanksEngine.build(torch.from_numpy(users),
                                    torch.from_numpy(items), cfg, 1,
                                    backend=inner, device="cpu")
    same = ReverseKRanksEngine(eng.users, eng.rank_table, cfg, backend=inner)
    qs = torch.from_numpy(off_grid(items, 8))
    got = eng.query_batch(qs, K, 1.0)
    _same_selection(got, same.query_batch(qs, K, 1.0))
    old = torch.argsort(eng.user_remap)                    # new → old
    assert torch.equal(old[got.indices],
                       raw.query_batch(qs, K, 1.0).indices)


def test_generic_inner_runs_on_gathered_rows(problem):
    """An inner backend other than the stock dense and fused ones runs its
    own `bound_ranks` on the gathered kept rows, with the same selection
    as its full scan."""
    class MyDense(BK.DenseBackend):
        calls = 0

        def bound_ranks(self, rt, users, qs):
            MyDense.calls += 1
            return super().bound_ranks(rt, users, qs)

    users, items = problem
    full, _ = _own_engines("f32", users, items, "dense")
    eng = ReverseKRanksEngine(full.users, full.rank_table, full.config,
                              backend=BK.PrunedBackend(MyDense(),
                                                       block_size=BS))
    rng = np.random.default_rng(5)
    qs = torch.from_numpy((items[:1] * (1.0 + 1e-4 * rng.standard_normal(
        (16, D)))).astype(np.float32))
    _same_selection(eng.query_batch(qs, K, 1.0), full.query_batch(qs, K, 1.0))
    assert MyDense.calls == 1 and eng._backend.stats.fallback == ""


def test_pruning_regimes():
    """zipf_clustered: Zipf-sized clusters in contiguous row order, tight
    around their centers; mid_mixture: the same core with a 10 % noise
    floor, shuffled, which the k-means reorder turns back into tight
    blocks."""
    from repro_torch.data.pipeline import mid_mixture, zipf_clustered
    users, items, icl = zipf_clustered(0, 40_000, 300, 8, device="cpu")
    assert users.shape == (40_000, 8) and items.shape == (300, 8)
    assert icl.shape == (300,) and int(icl.max()) < 9
    dist = torch.cdist(users[:1000], users[:1000])
    assert float(dist.max()) < 1.0            # one tight cluster first
    users, items, icl = mid_mixture(0, 40_000, 300, 8, device="cpu")
    assert users.shape == (40_000, 8) and icl.shape == (300,)
    shuffled = P.build_block_summary(users, _dummy_rt(users))
    tight = P.build_block_summary(users[P.kmeans_layout(users)],
                                  _dummy_rt(users))
    width = lambda sm: float((sm.dim_max - sm.dim_min).mean())
    assert width(tight) < 0.5 * width(shuffled)


def _dummy_rt(users):
    """A placeholder f32 table of the users' length (the sketches of the
    users do not read it)."""
    from repro_torch.core.types import RankTable
    thr = torch.zeros((users.shape[0], 2))
    return RankTable(thr, torch.ones_like(thr), 1)


def test_registry_and_specs():
    assert "pruned" in BK.available_backends()
    bk = BK.get_backend("pruned")
    assert isinstance(bk, BK.PrunedBackend) and bk.inner.name == "dense"
    assert BK.get_backend("pruned:fused").inner.name == "fused"
    assert BK.get_backend("pruned:fused").name == "pruned:fused"
    assert RBK.get_backend("pruned:fused").name == "pruned:fused"
    with pytest.raises(ValueError, match="unknown query backend"):
        BK.get_backend("pruned:no-such-inner")


def test_summary_cache_is_per_generation(problem):
    users, items = problem
    full, eng = _own_engines("f32", users, items, "dense")
    bk = eng._backend
    a = bk.summary_for(full.rank_table, full.users)
    assert bk.summary_for(full.rank_table, full.users) is a
    for i in range(BK.PrunedBackend._SUMMARY_CACHE):
        bk.summary_for(full.rank_table, full.users.clone())
    assert bk.summary_for(full.rank_table, full.users) is not a


# ------------------------------------------------------------ K6 and K7
def _tiles(n, block_n):
    """Block lists that K6/K7 must take: kept tiles with the partial tail,
    duplicate (padding) ids, and a single tile."""
    nb = -(-n // block_n)
    return [np.array([0, 2, nb - 1], np.int32),
            np.array([nb - 1, 1, 1, nb - 1], np.int32),
            np.array([1], np.int32)]


@pytest.mark.parametrize("spec", SPECS)
def test_masked_plain_versions_are_the_full_scan_on_kept_rows(spec):
    """K6's and K7's plain versions: compacted in list order, each kept
    tile bitwise the full-scan wrapper's values on its rows, rows past n
    at m + 2."""
    users, items = clustered(4, n=300, m=200)
    _, _, prt, pu = _state(users, items, spec)
    qs = torch.from_numpy(off_grid(items, 19))
    full = ops.bound_ranks_batched_stored(pu, qs, prt)
    for ids in _tiles(300, 64):
        got = ops.bound_ranks_batched_pruned_stored(
            pu, qs, prt, torch.from_numpy(ids), block_n=64)
        ridx = P.row_indices(torch.from_numpy(ids), 64).long()
        past = ridx >= 300
        for g, f in zip(got, full):
            assert g.shape == (19, ids.size * 64)
            assert torch.equal(g[:, ~past], f[:, ridx[~past]])
            assert bool((g[:, past] == float(prt.m + 2)).all())


def test_masked_wrappers_reject_bad_block_ids():
    users, items = clustered(4, n=300, m=200)
    _, _, prt, pu = _state(users, items, "f32")
    qs = torch.from_numpy(items[:2])
    for bad in (np.array([5], np.int32), np.array([-1], np.int32),
                np.array([0], np.int64), np.zeros(0, np.int32)):
        with pytest.raises((TypeError, ValueError)):
            ops.bound_ranks_batched_pruned_stored(pu, qs, prt,
                                                  torch.from_numpy(bad),
                                                  block_n=64)


def test_masked_cpu_path_launches_nothing():
    before = dict(ops.LAUNCHES)
    users, items = clustered(4, n=300, m=200)
    for spec in SPECS:
        _, _, prt, pu = _state(users, items, spec)
        ops.bound_ranks_batched_pruned_stored(
            pu, torch.from_numpy(items[:3]), prt,
            torch.tensor([0, 4], dtype=torch.int32), block_n=64)
    assert ops.LAUNCHES == before
    assert _build._LIBS == {}


# ----------------------------------------------------------- the repairs
@pytest.mark.parametrize("d", [1, 37, 200, 1031])
def test_query_l1_does_not_depend_on_the_batch(d):
    """‖q‖₁ of a query is bitwise the same in any batch, B ∈ {1, 3, 16,
    19}: a fixed halving order of elementwise adds."""
    g = torch.Generator().manual_seed(d)
    qs = torch.randn((19, d), generator=g)
    full = Q.query_l1(qs)
    assert full.shape == (19,) and full.dtype == torch.float32
    for B in (1, 3, 16, 19):
        part = Q.query_l1(qs[:B])
        for i in range(B):
            assert torch.equal(Q.query_l1(qs[i:i + 1])[0], part[i])
            assert torch.equal(part[i], full[i])
    np.testing.assert_allclose(full.numpy(),
                               np.abs(qs.numpy().astype(np.float64)).sum(1),
                               rtol=1e-6)


@pytest.mark.parametrize("spec", SPECS)
def test_no_wrapper_refuses_a_large_d(spec):
    """d = 1,031 (beyond every former shared-memory cap): every wrapper
    takes it, as the reference's do."""
    d = 1031
    rng = np.random.default_rng(d)
    users = rng.integers(-2, 3, (70, d)).astype(np.float32)
    items = rng.integers(-2, 3, (40, d)).astype(np.float32)
    cfg = RankTableConfig(tau=9, omega=2, s=8, storage_dtype=spec)
    eng = ReverseKRanksEngine.build(torch.from_numpy(users),
                                    torch.from_numpy(items), cfg, 0,
                                    backend="fused", device="cpu")
    qs = torch.from_numpy(items[:3])
    su = eng.stored_users if eng.stored_users is not None else eng.users
    rt = eng.rank_table
    ops.bound_ranks_batched_stored(su, qs, rt)
    ops.bound_ranks_batched_pruned_stored(
        su, qs, rt, torch.tensor([1, 0], dtype=torch.int32), block_n=64)
    if spec == "f32":
        ops.bound_ranks_batched(eng.users, qs, rt.thresholds, rt.table,
                                m=rt.m)
        ops.build_table_rows(eng.users, qs, torch.ones(3), rt.thresholds)
        ops.exact_ranks(eng.users, torch.from_numpy(items), qs[0])
    assert eng.query_batch(qs, 5, 2.0).indices.shape == (3, 5)


# ----------------------------------------------------------------- card
def _card_state(spec, n, d, tau, seed):
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    users = torch.from_numpy(rng.integers(-4, 5, (n, d)).astype(
        np.float32)).to(dev)
    items = torch.from_numpy(rng.integers(-4, 5, (300, d)).astype(
        np.float32)).to(dev)
    cfg = RankTableConfig(tau=tau, omega=4, s=16, storage_dtype=spec)
    eng = ReverseKRanksEngine.build(users, items, cfg, seed, device=dev)
    su = eng.stored_users if eng.stored_users is not None else eng.users
    return eng, su, items


@pytest.mark.cuda
@pytest.mark.parametrize("spec", SPECS)
def test_masked_kernels_are_the_full_scan_on_card(spec):
    """K6 (f32) and K7 (bf16, int8) on the card: each kept tile bitwise
    K1's / K4's / K5's outputs on its rows, at B ∈ {1, 3, 16, 19}, with
    duplicate ids, a partial tail block and a single tile; rows past n
    at m + 2. Run on a machine with a GPU:
    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_pruning.py"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    eng, su, items = _card_state(spec, 1000, 37, 37, 3)
    rt = eng.rank_table
    for B in (1, 3, 16, 19):
        qs = items[:B].contiguous()
        full = ops.bound_ranks_batched_stored(su, qs, rt)
        for ids in _tiles(1000, 256):
            t = torch.from_numpy(ids).cuda()
            got = ops.bound_ranks_batched_pruned_stored(su, qs, rt, t,
                                                        block_n=256)
            ridx = P.row_indices(t, 256).long()
            past = ridx >= 1000
            for g, f in zip(got, full):
                assert torch.equal(g[:, ~past], f[:, ridx[~past]])
                assert bool((g[:, past] == float(rt.m + 2)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("spec", SPECS)
def test_kernels_take_a_large_d_on_card(spec):
    """K1/K4/K5 (and K6/K7) stream Qᵀ at d = 1,031, K2 and K3 take it
    too: on integer inputs, exactly their plain versions (est 1e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    eng, su, items = _card_state(spec, 700, 1031, 33, 4)
    rt = eng.rank_table
    qs = items[:19].contiguous()
    got = ops.bound_ranks_batched_stored(su, qs, rt)
    if spec == "f32":
        want = ref.ref_bound_ranks(eng.users, qs, rt.thresholds, rt.table,
                                   rt.m)
    else:
        rows, uscale, uslack = ops.stored_parts(su, spec)
        want = ref.ref_bound_ranks_stored(rows, uscale, uslack, qs,
                                          Q.query_l1(qs), rt)
    assert torch.equal(got[0], want[0].T) and torch.equal(got[1], want[1].T)
    torch.testing.assert_close(got[2], want[2].T, rtol=EST_RTOL, atol=0)
    ids = torch.tensor([2, 0], dtype=torch.int32, device="cuda")
    masked = ops.bound_ranks_batched_pruned_stored(su, qs, rt, ids,
                                                   block_n=256)
    ridx = P.row_indices(ids, 256).long()
    live = ridx < 700
    for g, f in zip(masked, got):
        assert torch.equal(g[:, live], f[:, ridx[live]])
    if spec == "f32":
        w = torch.randint(1, 4, (300,), device="cuda").float()  # exact sums
        assert torch.equal(
            ops.build_table_rows(eng.users, items, w, rt.thresholds),
            ref.ref_table_rows(eng.users, items, w, rt.thresholds))
        for q in (items[11], eng.users[0]):
            assert torch.equal(ops.exact_ranks(eng.users, items,
                                               q.contiguous()),
                               1 + ref.ref_exact_counts(eng.users, items, q))


@pytest.mark.cuda
@pytest.mark.parametrize("spec", SPECS)
def test_kernels_take_a_long_row_on_card(spec):
    """d = 30,000: K4/K5/K7 rows too long for two ring stages of whole
    rows stream through the ring in chunks (raw f32 rows past d ≈ 25,000,
    stored bf16 rows are still whole), K1/K6 stream Qᵀ. On integer inputs
    (exact scores in any order) the bounds are bitwise the plain
    version's, est within 1e-5, and K6/K7's kept rows bitwise the full
    scan's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.kernels import user_scores
    eng, su, items = _card_state(spec, 70, 30_000, 33, 5)
    rt = eng.rank_table
    rows = (su,) if spec == "f32" else (su, eng.users)
    if spec != "f32":
        cfg = user_scores.quant_launch_config(spec, True, 16, 30_000, 33)
        assert cfg["row_chunk"] < 30_000     # raw f32 rows go in chunks
    for u in rows:
        for B in (1, 3, 16):
            qs = items[:B].contiguous()
            got = ops.bound_ranks_batched_stored(u, qs, rt)
            if spec == "f32":
                want = ref.ref_bound_ranks(u, qs, rt.thresholds, rt.table,
                                           rt.m)
            else:
                r_, usc, usl = ops.stored_parts(u, spec)
                want = ref.ref_bound_ranks_stored(r_, usc, usl, qs,
                                                  Q.query_l1(qs), rt)
            assert torch.equal(got[0], want[0].T)
            assert torch.equal(got[1], want[1].T)
            torch.testing.assert_close(got[2], want[2].T, rtol=EST_RTOL,
                                       atol=0)
            ids = torch.tensor([1, 0, 1], dtype=torch.int32, device="cuda")
            masked = ops.bound_ranks_batched_pruned_stored(u, qs, rt, ids,
                                                           block_n=64)
            ridx = P.row_indices(ids, 64).long()
            live = ridx < 70
            for g, f in zip(masked, got):
                assert torch.equal(g[:, live], f[:, ridx[live]])


@pytest.mark.cuda
def test_k6_at_its_edges_on_card():
    """K6 on the card at tile sizes 256 and 100, over a tail tile past n
    and duplicate ids, at B in 1, 3, 16, 19, on integer inputs: kept rows
    bitwise K1's, rows past n at m + 2, bounds bitwise the plain version's
    (`chip_smoke.k1_edges`, case "k6", which phase 3 runs too). Run on a
    machine with a GPU:
    PYTHONPATH=src:. python -m pytest -m cuda tests/test_torch_pruning.py"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.kernels import user_scores
    chip_smoke.k1_edges(torch, ops, ref, user_scores, P, "k6")
