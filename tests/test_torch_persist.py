"""The port's durability (`repro_torch.index.persist`, the engine's
`attach_persister`, `restore` and WAL appends) on the CPU.

Templates: tests/test_persist.py's ten cases (bitwise restore at every
spec, a rebuild between mutations, the torn newest spill, no valid
spill, a torn WAL tail, a corrupt WAL interior, a replay divergence, an
unknown op, a WAL write failure, the injected torn spill), run with
device="cpu". Then what the port adds:

  * a restored engine's `rebuild()` is bitwise the unrestored engine's
    (the spill carries the base's positions and weights and the build
    generator's state, where the reference carries its JAX key);
  * the WAL layout is the reference's: `repro.index.persist._read_wal`
    decodes a WAL the port wrote into the same ops, seqs and arrays, and
    the port's reader decodes the reference's;
  * a spill of the JAX package raises `PersistError` in the port;
  * a port engine mutated like its reference twin, spilled and restored,
    still meets the parity contract against the live reference engine
    on integer inputs (delta state, correction, bounds bitwise;
    selections equal up to ties).
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.core.engine import ReverseKRanksEngine
from repro_torch.core.types import RankTableConfig
from repro_torch.index import IndexPersister, PersistError
from repro_torch.index import persist as P
from repro_torch.obs import registry as obs
from repro_torch.serve import faults

K, C = 7, 2.0
SPECS = ("f32", "bf16", "int8")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads, so torch does not starve the timing-sensitive
    tests that share the run."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def chaos_hygiene():
    old = obs.get_default()
    obs.set_default(obs.MetricsRegistry())
    try:
        yield
    finally:
        faults.clear()
        obs.set_default(old)


@pytest.fixture(scope="module")
def problem():
    """(users (192, 12), items (96, 12)) f32, Gaussian norms, from numpy."""
    rng = np.random.default_rng(42)
    users = rng.normal(size=(192, 12)).astype(np.float32)
    scale = 1.0 + 0.3 * rng.normal(size=(96, 1))
    items = (rng.normal(size=(96, 12)) * np.abs(scale)).astype(np.float32)
    return torch.from_numpy(users), torch.from_numpy(items)


def _build(problem, spec="f32", backend="dense"):
    users, items = problem
    cfg = RankTableConfig(tau=16, omega=4, s=16, storage_dtype=spec)
    return ReverseKRanksEngine.build(users, items, cfg, 1, backend=backend,
                                     device="cpu")


def _mutate_a(eng, problem):
    users, items = problem
    ids = eng.insert_items(items[:5] * 1.05)
    eng.delete_items([int(ids[1])])
    eng.upsert_users(users[:2] * 1.2, indices=np.array([0, 7]))
    return ids


def _mutate_b(eng, problem):
    users, items = problem
    eng.upsert_users(users[3:5] * 0.9)          # append two new users
    eng.delete_users([2])


def _same(a, b, what):
    assert (a is None) == (b is None), what
    if a is not None:
        assert a.dtype == b.dtype, what
        assert torch.equal(a, b), what


def _assert_same_engine(got, want, problem):
    """Bitwise equality of a restored engine and the engine it stands
    for: the lineage counters, every rank-table field as stored, the
    users and their spec-space storage, the delta state and correction,
    the remap, and every field of a served batch and query."""
    users, items = problem
    gs, ws = got.current_snapshot(), want.current_snapshot()
    assert gs.epoch == ws.epoch
    assert got._next_item_id == want._next_item_id
    rt_g, rt_w = gs.rank_table, ws.rank_table
    for f in rt_w._fields:
        if f == "m":
            assert rt_g.m == rt_w.m
        else:
            _same(getattr(rt_g, f), getattr(rt_w, f), f"rank-table {f}")
    _same(gs.users, ws.users, "users")
    assert (gs.stored_users is None) == (ws.stored_users is None)
    if ws.stored_users is not None:
        for f in ws.stored_users._fields:
            _same(getattr(gs.stored_users, f), getattr(ws.stored_users, f),
                  f"stored users {f}")
    for f in ("base_live", "added_ids", "user_live"):
        np.testing.assert_array_equal(getattr(gs.delta, f),
                                      getattr(ws.delta, f), f)
    assert gs.delta.touched_users == ws.delta.touched_users
    _same(gs.delta.added_items, ws.delta.added_items, "added items")
    assert (gs.corr is None) == (ws.corr is None)
    if ws.corr is not None:
        assert gs.corr.m_new == ws.corr.m_new
        for f in ws.corr._fields:
            if f != "m_new":
                _same(getattr(gs.corr, f), getattr(ws.corr, f),
                      f"correction {f}")
    for f in ("items", "samples", "weights", "positions", "order"):
        _same(getattr(gs.base, f), getattr(ws.base, f), f"base {f}")
    np.testing.assert_array_equal(gs.base.item_ids, ws.base.item_ids)
    if ws.user_remap is None:
        assert gs.user_remap is None
    else:
        np.testing.assert_array_equal(gs.user_remap, ws.user_remap)
    qs = items[:4] * 1.01
    for rg, rw in ((got.query_batch(qs, K, C), want.query_batch(qs, K, C)),
                   (got.query(qs[0], K, C), want.query(qs[0], K, C))):
        for f in rw._fields:
            _same(getattr(rg, f), getattr(rw, f), f"query field {f}")


def _restore(path, backend="dense"):
    return ReverseKRanksEngine.restore(path, backend=backend, device="cpu")


def _spill_paths(d):
    return sorted(os.path.join(d, fn) for fn in os.listdir(d)
                  if fn.startswith("spill-"))


def _wal_paths(d):
    return sorted(os.path.join(d, fn) for fn in os.listdir(d)
                  if fn.startswith("wal-"))


def _truncate(path, keep=None):
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size // 2 if keep is None else keep)


# ------------------------------------------------------------ round trips
@pytest.mark.parametrize("spec", SPECS)
def test_restore_is_bitwise_after_mutations(tmp_path, problem, spec):
    eng = _build(problem, spec)
    eng.attach_persister(IndexPersister(tmp_path))
    _mutate_a(eng, problem)
    _mutate_b(eng, problem)
    got = _restore(tmp_path)
    _assert_same_engine(got, eng, problem)


def test_restore_after_rebuild_and_postspill_mutations(tmp_path, problem):
    """A rebuild spills the new epoch and rotates the WAL inside the
    locked swap, so mutations on either side of it land in exactly one
    durable point: the round trip stays bitwise across the rotation."""
    eng = _build(problem)
    eng.attach_persister(IndexPersister(tmp_path))
    _mutate_a(eng, problem)
    eng.rebuild(reason="test")
    _mutate_b(eng, problem)
    assert len(_spill_paths(tmp_path)) == 2     # baseline + rebuild epoch
    got = _restore(tmp_path)
    _assert_same_engine(got, eng, problem)
    # durability re-arms on the restored engine too
    got.attach_persister(IndexPersister(tmp_path))
    _mutate_b(got, problem)
    again = _restore(tmp_path)
    _assert_same_engine(again, got, problem)


# -------------------------------------------------------- torn/corrupt IO
def test_torn_newest_spill_falls_back_to_previous_durable_point(
        tmp_path, problem):
    eng = _build(problem)
    eng.attach_persister(IndexPersister(tmp_path))
    _mutate_a(eng, problem)
    eng.rebuild(reason="test")                  # second durable point
    _truncate(_spill_paths(tmp_path)[-1])       # crash mid-spill
    # the same lineage at the previous durable point: baseline + replay
    # of _mutate_a, no rebuild
    ref = _build(problem)
    _mutate_a(ref, problem)
    got = _restore(tmp_path)
    _assert_same_engine(got, ref, problem)


def test_no_valid_spill_raises_rebuild_from_master(tmp_path, problem):
    eng = _build(problem)
    eng.attach_persister(IndexPersister(tmp_path))
    eng.rebuild(reason="test")
    for p in _spill_paths(tmp_path):
        _truncate(p, keep=len(P.SPILL_MAGIC) + 3)
    with pytest.raises(PersistError, match="rebuild from the master"):
        _restore(tmp_path)


def test_torn_wal_tail_accepts_prefix(tmp_path, problem):
    """A crash mid-append tears the LAST record: the intact prefix is the
    durable point (accepted with a warning), the torn tail is dropped."""
    eng = _build(problem)
    eng.attach_persister(IndexPersister(tmp_path))
    _mutate_a(eng, problem)                     # prefix records
    eng.delete_users([4])                       # final record → torn
    wal = _wal_paths(tmp_path)[-1]
    _truncate(wal, keep=os.path.getsize(wal) - 5)
    ref = _build(problem)
    _mutate_a(ref, problem)
    got = _restore(tmp_path)
    _assert_same_engine(got, ref, problem)


def test_corrupt_wal_interior_raises(tmp_path, problem):
    """Corruption with an INTACT record after it is not a torn tail: the
    op sequence is untrustworthy, and loading refuses rather than replay
    around the hole."""
    eng = _build(problem)
    eng.attach_persister(IndexPersister(tmp_path))
    _mutate_a(eng, problem)                     # several records
    wal = _wal_paths(tmp_path)[-1]
    with open(wal, "r+b") as f:                 # flip a payload byte of
        f.seek(16 + 5)                          # record 0 (16 B header)
        b = f.read(1)
        f.seek(16 + 5)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(PersistError):
        _restore(tmp_path)


def test_replay_divergence_raises(tmp_path, problem):
    """A WAL whose recorded insert ids disagree with what replay assigns
    is a corrupted or foreign log: refuse, never serve mismatched ids."""
    users, items = problem
    eng = _build(problem)
    p = IndexPersister(tmp_path)
    eng.attach_persister(p)
    eng.insert_items(items[:2] * 1.03)
    p.append("insert_items", {"vectors": (items[2:3] * 1.01).numpy(),
                              "ids": np.array([4242], np.int64)})
    with pytest.raises(PersistError, match="diverged"):
        _restore(tmp_path)


def test_unknown_wal_op_rejected_at_append(tmp_path):
    p = IndexPersister(tmp_path)
    with pytest.raises(ValueError, match="unknown WAL op"):
        p.append("drop_everything", {})


# ------------------------------------------------------ injected failures
def test_wal_write_failure_degrades_then_spill_rearms(tmp_path, problem):
    """An injected WAL write error: serving continues, durability drops
    to the last spill (the failed and later mutations are NOT durable),
    and the next rebuild's spill re-arms logging."""
    eng = _build(problem)
    p = IndexPersister(tmp_path)
    eng.attach_persister(p)
    faults.install(faults.FaultPlan(seed=0, rules=[
        faults.FaultRule("persist.wal_write", mode="raise", max_fires=1)]))
    _mutate_a(eng, problem)                     # first append dies
    assert p._wal_broken
    assert p._m_wal_errors.value >= 1
    res = eng.query_batch(problem[1][:2], K, C)     # still serving
    assert bool((res.r_lo <= res.r_up).all())
    # the lost tail is EXPLICIT: restore sees only the baseline spill
    got = _restore(tmp_path)
    assert got.current_snapshot().epoch == 0
    eng.rebuild(reason="re-baseline")           # spill re-arms the WAL
    assert not p._wal_broken
    _mutate_b(eng, problem)                     # durable again
    _assert_same_engine(_restore(tmp_path), eng, problem)


def test_failed_spill_of_a_compacting_rebuild_disarms_the_wal(
        tmp_path, problem, monkeypatch):
    """A rebuild whose spill raises OSError (disk full) stands, but its
    compaction renumbers the users: a later `delete_users` logged onto the
    previous spill's WAL would replay onto the wrong rows. The failed
    spill disarms the WAL, so the restore is the previous durable point,
    and the next spill that succeeds re-arms it."""
    eng = _build(problem)
    p = IndexPersister(tmp_path)
    eng.attach_persister(p)
    _mutate_a(eng, problem)
    eng.delete_users([5, 9, 11])
    ref = _build(problem)                       # the last durable point
    _mutate_a(ref, problem)
    ref.delete_users([5, 9, 11])

    def disk_full(*_):
        raise OSError(28, "No space left on device")
    with monkeypatch.context() as mp:
        mp.setattr(os, "replace", disk_full)
        rec = eng.rebuild(reason="test", compact_dead_above=0.0)
    assert rec is not None and rec.users_compacted == 3
    assert p._wal_broken
    assert p._m_wal_errors.value == 1
    eng.delete_users([0])                       # row 0 of the new numbering
    assert eng.current_snapshot().users.shape[0] == 192 - 3
    _assert_same_engine(_restore(tmp_path), ref, problem)
    eng.rebuild(reason="re-baseline")           # spill re-arms the WAL
    assert not p._wal_broken
    _mutate_b(eng, problem)
    _assert_same_engine(_restore(tmp_path), eng, problem)


def test_injected_torn_spill_falls_back(tmp_path, problem):
    """The persist.spill torn-mode fault writes half a spill, as a crash
    mid-spill would; recovery detects it by checksum and falls back to
    the previous durable point."""
    eng = _build(problem)
    faults.install(faults.FaultPlan(seed=0, rules=[
        faults.FaultRule("persist.spill", mode="torn", after=1,
                         max_fires=1)]))
    eng.attach_persister(IndexPersister(tmp_path))  # baseline spill intact
    _mutate_a(eng, problem)
    eng.rebuild(reason="test")                  # this spill is torn
    ref = _build(problem)
    _mutate_a(ref, problem)
    got = _restore(tmp_path)
    _assert_same_engine(got, ref, problem)


# ------------------------------------------------------- what differs here
@pytest.mark.parametrize("spec", SPECS)
def test_restored_rebuild_is_bitwise_the_unrestored(tmp_path, problem, spec):
    """The spill carries the base's positions and weights and the build
    generator's state: a restored engine's `rebuild()` draws what the
    running engine's draws, and the two stay bitwise after it, after the
    mutations that follow and through a second rebuild."""
    eng = _build(problem, spec, backend="fused")
    eng.attach_persister(IndexPersister(tmp_path))
    _mutate_a(eng, problem)
    _mutate_b(eng, problem)
    got = _restore(tmp_path, backend="fused")
    assert got._generator_state is not None
    assert torch.equal(got._generator_state[1], eng._generator_state[1])
    ra, rb = eng.rebuild(reason="a"), got.rebuild(reason="b")
    assert ra.epoch_after == rb.epoch_after
    _assert_same_engine(got, eng, problem)
    users, items = problem
    for e in (eng, got):
        e.insert_items(items[10:12] * 0.97)
        e.delete_users([5])
        e.rebuild(compact_dead_above=0.0)
    _assert_same_engine(got, eng, problem)


def test_spill_without_generator_state_restores_given_positions(
        tmp_path, problem):
    """An engine built from given positions and weights has no generator
    state to spill: its restored twin restores bitwise and, like it,
    rebuilds only from given positions and weights."""
    users, items = problem
    cfg = RankTableConfig(tau=16, omega=4, s=16)
    from repro_torch.core import rank_table as T
    g = torch.Generator().manual_seed(3)
    pos, w = T.stratified_sample_indices(items.shape[0], cfg, g)
    eng = ReverseKRanksEngine.build(users, items, cfg, None, device="cpu",
                                    positions=pos, weights=w)
    eng.attach_persister(IndexPersister(tmp_path))
    _mutate_a(eng, problem)
    got = _restore(tmp_path)
    _assert_same_engine(got, eng, problem)
    assert got._generator_state is None
    with pytest.raises(ValueError, match="positions="):
        got.rebuild()
    m = got.current_snapshot().m_live
    pos2, w2 = T.stratified_sample_indices(m, cfg, g)
    for e in (eng, got):
        e.rebuild(positions=pos2, weights=w2)
    _assert_same_engine(got, eng, problem)


def test_spill_times_and_framing(tmp_path, problem):
    """The spill is one CRC32/u64-framed file of the port's magic, and
    `last_spill` accounts for its bytes and its three stages."""
    eng = _build(problem, "int8")
    p = IndexPersister(tmp_path)
    eng.attach_persister(p)
    (path,) = _spill_paths(tmp_path)
    st = p.last_spill
    assert st.bytes == os.path.getsize(path) > P._SPILL_HDR
    assert min(st.d2h_s, st.encode_s, st.write_s) >= 0.0
    assert p._m_spill_bytes.value == st.bytes
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == P.SPILL_MAGIC
    assert int.from_bytes(data[12:20], "little") == len(data) - 20
    import zlib
    assert int.from_bytes(data[8:12], "little") == zlib.crc32(data[20:])


# ------------------------------------------------- against the reference
def _ref_engine(problem, spec="f32"):
    import jax
    from repro.core.engine import ReverseKRanksEngine as RefEngine
    from repro.core.types import RankTableConfig as RefConfig
    users, items = problem
    cfg = RefConfig(tau=16, omega=4, s=16, storage_dtype={
        "f32": "float32", "bf16": "bfloat16", "int8": "int8"}[spec])
    return RefEngine.build(jax.numpy.asarray(users.numpy()),
                           jax.numpy.asarray(items.numpy()), cfg,
                           jax.random.PRNGKey(1))


def _ref_mutations(eng, problem):
    """_mutate_a and _mutate_b on a reference engine."""
    import jax.numpy as jnp
    users, items = (jnp.asarray(x.numpy()) for x in problem)
    ids = eng.insert_items(items[:5] * 1.05)
    eng.delete_items([int(ids[1])])
    eng.upsert_users(users[:2] * 1.2, indices=np.array([0, 7]))
    eng.upsert_users(users[3:5] * 0.9)
    eng.delete_users([2])


def _records_equal(got, want):
    assert [(r.op, r.seq) for r in got] == [(r.op, r.seq) for r in want]
    for g, w in zip(got, want):
        assert sorted(g.arrays) == sorted(w.arrays), g.op
        for name, a in w.arrays.items():
            b = np.asarray(g.arrays[name])
            a = np.asarray(a)
            assert b.dtype == a.dtype and b.shape == a.shape, (g.op, name)
            np.testing.assert_array_equal(b, a, err_msg=f"{g.op} {name}")


def test_wal_is_readable_by_both_packages(tmp_path, problem):
    """The port writes the reference's WAL layout and reads the
    reference's: each package's `_read_wal` decodes the other's log into
    the same ops, seqs and arrays (dtypes and shapes included) as the
    writing package's own reader."""
    from repro.index import IndexPersister as RefPersister
    from repro.index import persist as RP
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    eng = _build(problem)
    eng.attach_persister(IndexPersister(port_dir))
    _mutate_a(eng, problem)
    _mutate_b(eng, problem)
    ref = _ref_engine(problem)
    ref.attach_persister(RefPersister(ref_dir))
    _ref_mutations(ref, problem)
    (port_wal,), (ref_wal,) = _wal_paths(port_dir), _wal_paths(ref_dir)
    own = P._read_wal(port_wal)
    assert [r.op for r in own] == ["insert_items", "delete_items",
                                   "upsert_users", "upsert_users",
                                   "delete_users"]
    _records_equal(RP._read_wal(port_wal), own)
    _records_equal(P._read_wal(ref_wal), RP._read_wal(ref_wal))
    # the two logs hold the same mutations
    _records_equal(P._read_wal(ref_wal), own)


def test_reference_spill_is_refused(tmp_path, problem):
    """A spill of the JAX package is refused with PersistError (its
    magic), never read as the port's: restore then finds no valid
    spill."""
    from repro.index import IndexPersister as RefPersister
    ref = _ref_engine(problem)
    ref.attach_persister(RefPersister(tmp_path))
    (path,) = _spill_paths(tmp_path)
    with pytest.raises(PersistError, match="JAX package"):
        P._read_spill(path)
    with pytest.raises(PersistError, match="rebuild from the master"):
        _restore(tmp_path)


@pytest.mark.parametrize("spec", SPECS)
def test_restored_engine_meets_the_parity_contract(tmp_path, spec):
    """A port engine started from the reference's table, positions and
    weights, persisted and mutated like its reference twin, then
    restored: the delta state equals the reference's, the correction is
    bitwise the reference's, r↓/r↑ are bitwise the reference's dense
    delta query run op by op, and the selection equals it up to ties of
    the selection key."""
    import jax
    import jax.numpy as jnp
    from repro.core import rank_table as R
    from repro_torch import convert
    from repro_torch.core import query as Q
    rng = np.random.default_rng(0)
    users = rng.integers(-4, 5, (256, 16)).astype(np.float32)
    items = rng.integers(-4, 5, (208, 16)).astype(np.float32)
    base, new = items[:200], items[200:]
    ref = _ref_engine((torch.from_numpy(users), torch.from_numpy(base)),
                      spec)
    key = jax.random.PRNGKey(1)
    pos, w = R.stratified_sample_indices(key, 200, ref.config)
    st = convert.from_reference(ref.rank_table, users, base, pos, w,
                                device="cpu")
    cfg = RankTableConfig(tau=16, omega=4, s=16, storage_dtype=spec)
    port = ReverseKRanksEngine(st.users, st.rank_table, cfg, items=st.items,
                               positions=st.positions, weights=st.weights)
    port.attach_persister(IndexPersister(tmp_path))
    up = rng.integers(-4, 5, (3, 16)).astype(np.float32)
    for e, arr in ((ref, jnp.asarray), (port, torch.from_numpy)):
        ids = e.insert_items(arr(new))
        e.delete_items([3, 17, int(ids[1])])
        e.upsert_users(arr(up[:2]), indices=[5, 40])
        e.upsert_users(arr(up[2:]))
        e.delete_users([9, 256])
    got = _restore(tmp_path)
    rs, gs = ref.current_snapshot(), got.current_snapshot()
    assert gs.epoch == rs.epoch == 5
    for f in ("base_live", "added_ids", "user_live"):
        np.testing.assert_array_equal(getattr(gs.delta, f),
                                      np.asarray(getattr(rs.delta, f)), f)
    want = convert.correction_from_reference(rs.corr, device="cpu")
    for f in want._fields:
        if f != "m_new":
            _same(getattr(gs.corr, f), getattr(want, f), f"correction {f}")
    qs = base[(1 + np.arange(8) * 13) % 200]
    with jax.disable_jit():     # the reference's arithmetic as written
        rr = ref.query_batch(jnp.asarray(qs), K, C)
    gr = got.query_batch(torch.from_numpy(qs), K, C)
    np.testing.assert_array_equal(gr.r_lo.numpy(), np.asarray(rr.r_lo))
    np.testing.assert_array_equal(gr.r_up.numpy(), np.asarray(rr.r_up))
    np.testing.assert_array_equal(gr.R_lo_k.numpy(), np.asarray(rr.R_lo_k))
    np.testing.assert_array_equal(gr.R_up_k.numpy(), np.asarray(rr.R_up_k))
    full = Q._delta_bounds_batch(gs.rank_table, gs.query_users(),
                                 torch.from_numpy(qs), gs.corr)
    keyv = Q.lemma1_key(*full, R_lo_k=gr.R_lo_k, R_up_k=gr.R_up_k, c=C,
                        m_items=gs.corr.selection_m())[0].numpy()
    for b in range(qs.shape[0]):
        kth = np.sort(keyv[b])[K - 1]
        for u in set(gr.indices[b].tolist()) ^ set(
                np.asarray(rr.indices[b]).tolist()):
            assert keyv[b, u] <= kth + 1e-3, (b, u)
