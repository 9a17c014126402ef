"""The port's embedding-production step (`repro_torch.data.mf`,
`data.pipeline.synthetic_ratings` / `ratings_from`) against the JAX
reference fed the same draws, on the CPU.

Tolerances: a rating is the reference's to rtol 1e-6 plus the f32
rounding bound of its 16-term dot product summed in another order
(2·16·2⁻²⁴·Σ|ut·vt|; the reference's `einsum` picks its own order). One
epoch of `mf_epoch` from the reference's `init_mf` state and permutation
agrees to 1e-6 absolute on every parameter (values up to ~1.3; the
per-row gradient sums run in another order) and to rtol 1e-6 on the mean
loss. `embeddings` is bitwise.

The reference's `test_mf_learns_low_rank_structure`
(tests/test_train_substrate.py) is ported as is. This file imports
`repro.data.mf` and `repro.data.pipeline` directly, never
`repro.configs`, which pulls in the LM substrate.
"""
import jax
import numpy as np
import pytest
import torch

from repro.data.mf import MFConfig as RefMFConfig
from repro.data.mf import embeddings as ref_embeddings
from repro.data.mf import init_mf as ref_init_mf
from repro.data.mf import mf_epoch as ref_mf_epoch
from repro.data.pipeline import synthetic_ratings as ref_synthetic_ratings
from repro_torch.data.mf import MFConfig, _loss, _sgd_step, embeddings, \
    mf_epoch, train_mf
from repro_torch.data.pipeline import ratings_from, synthetic_ratings

N, M, N_OBS = 300, 200, 40_000


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def ref_draws():
    """The reference's `synthetic_ratings(PRNGKey(0), ...)` and the draws
    inside it, split as the reference splits its key."""
    key = jax.random.PRNGKey(0)
    ii, jj, rr = ref_synthetic_ratings(key, N, M, n_obs=N_OBS)
    ku, kv, _, _, ke = jax.random.split(key, 5)
    ut = jax.random.normal(ku, (N, 16)) / 16 ** 0.25
    vt = jax.random.normal(kv, (M, 16)) / 16 ** 0.25
    noise = jax.random.normal(ke, (N_OBS,))
    return dict(key=key, ii=ii, jj=jj, rr=rr, ut=ut, vt=vt, noise=noise)


def test_ratings_from_matches_reference(ref_draws):
    r = ref_draws
    got = ratings_from(_t(r["ut"]), _t(r["vt"]), _t(r["ii"]), _t(r["jj"]),
                       _t(r["noise"])).numpy()
    want = np.asarray(r["rr"])
    assert got.dtype == np.float32 and got.shape == (N_OBS,)
    mag = np.abs(np.asarray(r["ut"])[np.asarray(r["ii"])]
                 * np.asarray(r["vt"])[np.asarray(r["jj"])]).sum(1)
    eps = 2 * 16 * 2.0 ** -24 * mag
    assert np.all(np.abs(got - want) <= 1e-6 * np.abs(want) + eps)


@pytest.mark.parametrize("chunk", [1, 7, 4096, 1 << 22])
def test_ratings_do_not_depend_on_the_chunk(ref_draws, chunk):
    r = ref_draws
    args = [_t(r[k]) for k in ("ut", "vt", "ii", "jj", "noise")]
    whole = ratings_from(*args, chunk=N_OBS)
    assert torch.equal(ratings_from(*args, chunk=chunk), whole)


def test_synthetic_ratings_shapes_and_seed():
    a = synthetic_ratings(0, N, M, 5000, device="cpu")
    b = synthetic_ratings(0, N, M, 5000, device="cpu")
    c = synthetic_ratings(1, N, M, 5000, device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[2], c[2])
    assert torch.equal(synthetic_ratings(0, N, M, 5000, device="cpu",
                                         chunk=333)[2], a[2])
    ii, jj, rr = a
    assert (ii.dtype, jj.dtype, rr.dtype) == (torch.int32, torch.int32,
                                              torch.float32)
    assert 0 <= int(ii.min()) and int(ii.max()) < N
    assert 0 <= int(jj.min()) and int(jj.max()) < M
    # r = u·v + 0.05·ε with u, v ~ N(0, 1/4)^16: variance ≈ 1 + 0.0025
    assert 0.8 < float(rr.var()) < 1.2


@pytest.mark.parametrize("lr", [0.05, 10.0])
def test_mf_epoch_matches_reference(ref_draws, lr):
    r = ref_draws
    ref_cfg = RefMFConfig(d=16, batch=2048, lr=lr)
    state = ref_init_mf(r["key"], N, M, ref_cfg)
    perm = jax.random.permutation(jax.random.PRNGKey(3), N_OBS)
    want, want_loss = ref_mf_epoch(state, r["ii"], r["jj"], r["rr"], perm,
                                   ref_cfg)
    ours = {k: _t(v) for k, v in state.items()}
    got, loss = mf_epoch(ours, _t(r["ii"]), _t(r["jj"]), _t(r["rr"]),
                         _t(perm), MFConfig(d=16, batch=2048, lr=lr))
    for k in ("u", "v", "bu", "bv"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6)
        # the given state is left as it was
        assert torch.equal(ours[k], _t(state[k]))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)


def test_sparse_step_is_the_dense_step(ref_draws):
    """The sparse update of the rows a batch gathers equals the dense
    `p − lr·g` of the same summed gradient in every row, untouched rows
    included (bitwise); the working parameters carry each row's bias in
    their last column."""
    r = ref_draws
    cfg = MFConfig(d=16, batch=256, lr=10.0)
    st = {k: _t(v) for k, v in ref_init_mf(r["key"], N, M, RefMFConfig(
        d=16)).items()}
    st["bu"] += 0.25            # nonzero biases, so untouched rows show
    uv = (torch.cat([st["u"], st["bu"][:, None]], 1),
          torch.cat([st["v"], st["bv"][:, None]], 1))
    i = _t(r["ii"])[:256].long()
    j = _t(r["jj"])[:256].long()
    rr = _t(r["rr"])[:256]
    leaves = [uv[0][i].requires_grad_(), uv[1][j].requires_grad_()]
    grads = torch.autograd.grad(_loss(*leaves, rr, cfg.l2), leaves)
    dense = [p - cfg.lr * torch.zeros_like(p).index_add_(0, idx, g)
             for p, idx, g in zip(uv, (i, j), grads)]
    got = tuple(p.clone() for p in uv)
    acc = tuple(torch.zeros_like(p) for p in uv)
    _sgd_step(got, acc, i, j, rr, cfg)
    assert int((i.bincount(minlength=N) > 1).sum()) > 0     # repeated rows
    assert int((i.bincount(minlength=N) == 0).sum()) > 0   # untouched rows
    for a, b, s in zip(got, dense, acc):
        assert torch.equal(a, b)
        assert not s.any()          # the sums are cleared for the next


def test_embeddings_match_reference(ref_draws):
    state = ref_init_mf(ref_draws["key"], N, M, RefMFConfig(d=16))
    state = {**state, "bu": state["bu"] + 0.5, "bv": state["bv"] - 0.25}
    want_u, want_i = ref_embeddings(state)
    got_u, got_i = embeddings({k: _t(v) for k, v in state.items()})
    assert torch.equal(got_u, _t(want_u)) and torch.equal(got_i, _t(want_i))
    assert got_u.shape == (N, 18) and got_i.shape == (M, 18)


def test_train_mf_is_deterministic():
    ii, jj, rr = synthetic_ratings(0, N, M, 10_000, device="cpu")
    cfg = MFConfig(d=16, epochs=2, batch=1024, lr=10.0)
    a, la = train_mf(0, N, M, ii, jj, rr, cfg, device="cpu")
    b, lb = train_mf(0, N, M, ii, jj, rr, cfg, device="cpu")
    assert la == lb
    assert all(torch.equal(a[k], b[k]) for k in a)
    c, _ = train_mf(0, N, M, ii, jj, rr, MFConfig(d=16, epochs=2, batch=1024,
                                                  lr=10.0, seed=1),
                    device="cpu")
    assert not torch.equal(a["u"], c["u"])      # cfg.seed orders the epochs


def test_mf_learns_low_rank_structure():
    ii, jj, rr = synthetic_ratings(0, 300, 200, n_obs=40_000, device="cpu")
    # Mean-loss SGD scales the per-example step by 1/batch, so lr must be
    # O(batch / per-user coverage) for visible progress in 10 epochs at
    # this scale; lr=10 reaches ~75% loss reduction.
    state, losses = train_mf(0, 300, 200, ii, jj, rr,
                             MFConfig(d=16, epochs=10, batch=2048, lr=10.0),
                             device="cpu")
    assert losses[-1] < 0.6 * losses[0]
    assert all(a >= b - 1e-3 for a, b in zip(losses, losses[1:]))
    users, items = embeddings(state)
    assert users.shape == (300, 18) and items.shape == (200, 18)
    # bias folding preserves the rating model: u·v + bu + bv
    pred = float(users[5] @ items[7])
    want = float(state["u"][5] @ state["v"][7] + state["bu"][5]
                 + state["bv"][7])
    assert abs(pred - want) < 1e-4


def test_mf_needs_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthetic_ratings(0, 4, 4, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_mf(0, 4, 4, [0], [0], [1.0], MFConfig(d=2, epochs=1, batch=1))
