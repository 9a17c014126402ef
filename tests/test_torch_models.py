"""The port's LM substrate (`repro_torch.models`) against the live
reference (`repro.models`), on the CPU, at `reduced()` sizes.

For each of the ten architectures the reference's parameters
(`init_params(PRNGKey(0))`) cross through
`convert.model_params_from_reference`; then:

- at float32 (`dtype="float32"`), `forward_hidden` and `forward_logits`
  agree within rtol = atol = 1e-4, and so do six `decode_step`s, in
  their logits and in every cache leaf (the enc-dec after `encode` and
  `fill_cross_kv`), also when the port resumes from the reference's cache
  after three steps (`convert.cache_from_reference`);
- at the config's own bf16, the same within |Δ| ≤ 0.15 + 0.05·|ref|
  (0.15 is the reference's own prefill-vs-decode tolerance at bf16,
  tests/test_models_smoke.py; the two frameworks round bf16 products
  and activations at other places).

Pieces on their own, float32 within 1e-5 unless stated: the chunked
online softmax (S = 20, chunk = 8: causal, windowed, bidirectional), the
local-attention ring decoded past its window (20 steps at window 16),
MoE at the config's own capacity factor (drops on: the same dropped
tokens, the same outputs), top-k ties to the lower index, `wkv_chunked`
at (S, chunk) in (16, 4), (33, 33), (96, 32) (1e-4: its state sums a
chunk's products), `rglru_block` (the port's sequential scan against the
reference's associative one), the norms, RoPE, the sinusoidal positions
and the three MLP activations. The port's own `init_params` has the
reference's layout and shapes. Hygiene: two intra-op threads; one
reference run per (arch, dtype), module-scoped.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import layers as RL
from repro.models import recurrent as RR
from repro.models import transformer as RT
from repro_torch import configs, convert
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R
from repro_torch.models import transformer as T
from repro_torch.models.model import Model, make_prefill_step, \
    make_serve_step

ARCHS = ref_configs.ARCH_IDS
B, S, STEPS, CACHE = 2, 8, 6, 10
RESUME = 3                  # the decode step a converted cache resumes at
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=0.05, atol=0.15)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _cfgs(arch, dtype="float32", **changes):
    ref = dataclasses.replace(
        ref_configs.reduced(ref_configs.get_config(arch)), dtype=dtype,
        **changes)
    port = dataclasses.replace(
        configs.reduced(configs.get_config(arch)), dtype=dtype, **changes)
    return ref, port


def _np(x) -> np.ndarray:
    """Any reference or port array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _inputs(cfg):
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    frames = None
    if cfg.family == "encdec":
        frames = rng.normal(size=(B, cfg.enc_seq, cfg.d_model)
                            ).astype(np.float32)
    return tokens, frames


# the reference's entry points under `jit` (one trace each, not one a
# call: its layer scans would retrace on every eager call)
_hidden = jax.jit(RT.forward_hidden, static_argnames="cfg")
_decode = jax.jit(RT.decode_step, static_argnames="cfg")


def _run_reference(arch, dtype):
    cfg, _ = _cfgs(arch, dtype)
    params = RT.init_params(jax.random.PRNGKey(0), cfg)
    tokens, frames = _inputs(cfg)
    fr = None if frames is None else jnp.asarray(frames)
    hidden = _hidden(params, jnp.asarray(tokens), cfg=cfg, frames=fr)
    out = {"params": jax.tree.map(np.asarray, params), "tokens": tokens,
           "frames": frames, "hidden": _np(hidden),
           "logits": _np(RT._logits(params, hidden, cfg)), "steps": []}
    cache = RT.init_cache(cfg, B, CACHE)
    if cfg.family == "encdec":
        cache = RT.fill_cross_kv(params, cache,
                                 RT.encode(params, fr, cfg), cfg)
    for t in range(STEPS):
        lg, cache = _decode(params, cache, jnp.asarray(tokens[:, t:t + 1]),
                            cfg=cfg)
        out["steps"].append((_np(lg), {
            path: (str(leaf.dtype), _np(leaf))
            for path, leaf in _flat(cache["segments"])},
            int(cache["len"])))
        if t == RESUME - 1:
            out["resume"] = jax.tree.map(np.asarray, cache)
    return out


@pytest.fixture(scope="module")
def reference():
    runs = {}

    def get(arch, dtype="float32"):
        if (arch, dtype) not in runs:
            runs[(arch, dtype)] = _run_reference(arch, dtype)
        return runs[(arch, dtype)]

    return get


def _port(ref, arch, dtype):
    _, cfg = _cfgs(arch, dtype)
    params = convert.model_params_from_reference(ref["params"], cfg,
                                                 device="cpu")
    tokens = torch.from_numpy(ref["tokens"]).long()
    frames = (None if ref["frames"] is None
              else torch.from_numpy(ref["frames"]))
    return cfg, params, tokens, frames


def _check_decode(ref, cfg, params, tokens, frames, tol):
    cache = T.init_cache(cfg, B, CACHE, device="cpu")
    if cfg.family == "encdec":
        cache = T.fill_cross_kv(params, cache, T.encode(params, frames, cfg),
                                cfg)
    for t, (want, want_cache, want_len) in enumerate(ref["steps"]):
        lg, cache = T.decode_step(params, cache, tokens[:, t:t + 1], cfg)
        np.testing.assert_allclose(_np(lg), want, **tol,
                                   err_msg=f"step {t} logits")
        got_cache = dict(_flat(cache["segments"]))
        assert set(got_cache) == set(want_cache)
        for path, (dtype, leaf) in want_cache.items():
            assert str(got_cache[path].dtype) == f"torch.{dtype}", path
            np.testing.assert_allclose(_np(got_cache[path]), leaf, **tol,
                                       err_msg=f"step {t} cache {path}")
        assert cache["len"] == want_len


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference_f32(reference, arch):
    ref = reference(arch)
    cfg, params, tokens, frames = _port(ref, arch, "float32")
    hidden = T.forward_hidden(params, tokens, cfg, frames=frames)
    assert hidden.dtype == torch.float32
    np.testing.assert_allclose(_np(hidden), ref["hidden"], **F32_TOL)
    logits = T.forward_logits(params, tokens, cfg, frames=frames)
    assert logits.shape == (B, S, cfg.vocab)
    np.testing.assert_allclose(_np(logits), ref["logits"], **F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference_f32(reference, arch):
    ref = reference(arch)
    _check_decode(ref, *_port(ref, arch, "float32"), F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_resumes_from_a_reference_cache(reference, arch):
    """The reference's cache after RESUME steps, carried across by
    `convert.cache_from_reference`, decodes the remaining steps as the
    reference does."""
    ref = reference(arch)
    cfg, params, tokens, _ = _port(ref, arch, "float32")
    cache = convert.cache_from_reference(ref["resume"], device="cpu")
    assert cache["len"] == RESUME
    for t in range(RESUME, STEPS):
        lg, cache = T.decode_step(params, cache, tokens[:, t:t + 1], cfg)
        np.testing.assert_allclose(_np(lg), ref["steps"][t][0], **F32_TOL,
                                   err_msg=f"step {t} logits")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_matches_reference(reference, arch):
    ref = reference(arch, "bfloat16")
    cfg, params, tokens, frames = _port(ref, arch, "bfloat16")
    assert cfg.dtype == configs.get_config(arch).dtype == "bfloat16"
    logits = T.forward_logits(params, tokens, cfg, frames=frames)
    assert logits.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(logits), ref["logits"], **BF16_TOL)
    _check_decode(ref, cfg, params, tokens, frames, BF16_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_references_layout(arch):
    ref_cfg, cfg = _cfgs(arch, "bfloat16")
    want = {p: tuple(x.shape) for p, x in _flat(RT.abstract_params(ref_cfg))}
    got = T.init_params(0, cfg, device="cpu")
    assert {p: tuple(x.shape) for p, x in _flat(got)} == want
    assert all(x.dtype == torch.float32 for _, x in _flat(got))
    again = T.init_params(0, cfg, device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(_flat(got),
                                                          _flat(again)))


def test_facade_and_serving_steps(reference):
    ref = reference("qwen3-32b")
    cfg, params, tokens, _ = _port(ref, "qwen3-32b", "float32")
    model = Model(cfg)
    want = T.forward_logits(params, tokens, cfg)
    assert torch.equal(model.forward_logits(params, tokens), want)
    assert torch.equal(make_prefill_step(model)(params, {"tokens": tokens}),
                       want)
    step = make_serve_step(model)
    c1, c2 = (model.init_cache(B, CACHE, device="cpu") for _ in range(2))
    for t in range(3):
        a, c1 = step(params, c1, tokens[:, t:t + 1])
        b, c2 = T.decode_step(params, c2, tokens[:, t:t + 1], cfg)
        assert torch.equal(a, b)
    assert c1["len"] == 3


def test_reference_params_of_another_layout_are_refused(reference):
    ref = reference("gemma-2b")
    _, cfg = _cfgs("gemma-2b")
    bad = dict(ref["params"], lm_head={"w": np.zeros((64, 512), np.float32)})
    with pytest.raises(ValueError, match="parameter groups"):
        convert.model_params_from_reference(bad, cfg, device="cpu")
    _, cfg4 = _cfgs("gemma-2b", n_layers=4)
    with pytest.raises(ValueError, match="stacked layers"):
        convert.model_params_from_reference(ref["params"], cfg4,
                                            device="cpu")


def test_entry_points_without_device_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, cfg = _cfgs("gemma-2b")
    for call in (lambda: T.init_params(0, cfg),
                 lambda: T.init_cache(cfg, 1, 4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_bf16_products_reduce_in_f32():
    import repro_torch  # noqa: F401  (the import sets the switches)
    assert not torch.backends.cuda.matmul.\
        allow_bf16_reduced_precision_reduction


# ----------------------------------------------------------------- pieces
def _randn(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("causal, window", [(True, None), (True, 5),
                                            (False, None)],
                         ids=["causal", "windowed", "bidirectional"])
def test_attend_chunked_matches_reference(causal, window):
    rng = np.random.default_rng(1)
    q, k, v = (_randn(rng, 2, 20, 2, 2, 8), _randn(rng, 2, 20, 2, 8),
               _randn(rng, 2, 20, 2, 8))
    want = RL._attend_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window, chunk=8)
    got = L._attend_chunked(*(torch.from_numpy(x) for x in (q, k, v)),
                            causal=causal, window=window, chunk=8)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    # the chunked path and the direct one compute the same attention
    mask = None
    if causal:
        pos = torch.arange(20)
        mask = pos[:, None] >= pos[None, :]
        if window is not None:
            mask &= pos[:, None] - pos[None, :] < window
    direct = L._attend_direct(*(torch.from_numpy(x) for x in (q, k, v)),
                              mask)
    np.testing.assert_allclose(_np(got), _np(direct), rtol=1e-5, atol=1e-5)


def test_local_attention_ring_past_its_window():
    ref_cfg, cfg = _cfgs("recurrentgemma-9b")
    assert cfg.local_window == 16
    params = RT.init_params(jax.random.PRNGKey(2), ref_cfg)
    pp = convert.model_params_from_reference(jax.tree.map(np.asarray,
                                                          params), cfg,
                                             device="cpu")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (1, 20))
    rc, pc = RT.init_cache(ref_cfg, 1, 24), T.init_cache(cfg, 1, 24, "cpu")
    ring = pc["segments"][0]["b2"]["k"]
    assert ring.shape[2] == 16                 # T = min(24, window)
    for t in range(20):
        tok = tokens[:, t:t + 1]
        want, rc = _decode(params, rc, jnp.asarray(tok, jnp.int32),
                           cfg=ref_cfg)
        got, pc = T.decode_step(pp, pc, torch.from_numpy(tok), cfg)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-5, err_msg=f"step {t}")
    for path, leaf in _flat(rc["segments"]):
        np.testing.assert_allclose(
            _np(dict(_flat(pc["segments"]))[path]), _np(leaf), rtol=1e-5,
            atol=1e-5, err_msg=path)


@pytest.mark.parametrize("arch, seq", [("llama4-scout-17b-a16e", 32),
                                       ("moonshot-v1-16b-a3b", 32),
                                       ("moonshot-v1-16b-a3b", 512)],
                         ids=["top1", "top2", "top2-two-groups"])
def test_moe_drops_the_references_tokens(arch, seq):
    ref_cfg, cfg = _cfgs(arch)
    params = RT.init_params(jax.random.PRNGKey(4), ref_cfg)
    p_ref = jax.tree.map(lambda x: x[0],
                         params["segments"][0]["b0"]["moe"])
    p = {k: torch.from_numpy(np.array(v)) for k, v in p_ref.items()}
    x = _randn(np.random.default_rng(5), 2, seq, cfg.d_model)
    want = _np(RL.moe(p_ref, jnp.asarray(x), ref_cfg))
    got = _np(L.moe(p, torch.from_numpy(x), cfg))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the port's routing drops assignments at this capacity factor; with
    # one expert a token, a dropped token's output is exactly 0 in both
    Gs = max(min(cfg.moe_group_tokens // 2, seq), 1)
    keep = torch.cat([L.moe_route(p, torch.from_numpy(
        x[:, i:i + Gs].reshape(-1, cfg.d_model)), cfg)[1]
        for i in range(0, seq, Gs)])
    assert not bool(keep.all())
    if cfg.experts_per_tok == 1:
        dropped = ~keep[:, 0].numpy()
        ref_zero = (want.reshape(-1, cfg.d_model) == 0).all(axis=1)
        assert (dropped == ref_zero).all() and dropped.any()


def test_top_k_ties_to_the_lower_index():
    x = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1],
                  [0.3, 0.1, 0.3, 0.3]], np.float32)
    wv, wi = jax.lax.top_k(jnp.asarray(x), 3)
    gv, gi = L.top_k(torch.from_numpy(x), 3)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    assert np.array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("seq, chunk", [(16, 4), (33, 33), (96, 32)])
def test_wkv_chunked_matches_reference(seq, chunk):
    rng = np.random.default_rng(seq)
    r, k, v = (_randn(rng, 2, 2, seq, 8) * 0.5 for _ in range(3))
    logw = -np.exp(_randn(rng, 2, 2, seq, 8) - 1.0)
    u, s0 = _randn(rng, 2, 8) * 0.3, _randn(rng, 2, 2, 8, 8) * 0.1
    wy, ws = RR.wkv_chunked(*(jnp.asarray(a) for a in (r, k, v, logw, u,
                                                       s0)), chunk=chunk)
    gy, gs = R.wkv_chunked(*(torch.from_numpy(a) for a in (r, k, v, logw, u,
                                                           s0)), chunk=chunk)
    np.testing.assert_allclose(_np(gy), _np(wy), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(gs), _np(ws), rtol=1e-4, atol=1e-4)


def test_rglru_block_matches_reference():
    ref_cfg, cfg = _cfgs("recurrentgemma-9b")
    params = RT.init_params(jax.random.PRNGKey(6), ref_cfg)
    p_ref = jax.tree.map(lambda x: x[0],
                         params["segments"][0]["b0"]["rglru"])
    p = {k: torch.from_numpy(np.array(v)) for k, v in p_ref.items()}
    x = _randn(np.random.default_rng(8), 2, 40, cfg.d_model)
    want = jax.jit(RR.rglru_block, static_argnames="cfg")(
        p_ref, jnp.asarray(x), cfg=ref_cfg)
    got = R.rglru_block(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_norms_rope_and_positions_match_reference():
    rng = np.random.default_rng(9)
    x, scale = _randn(rng, 3, 5, 4, 16), _randn(rng, 16)
    for ours, theirs in ((L.rms_norm, RL.rms_norm),
                         (L.layer_norm, RL.layer_norm)):
        np.testing.assert_allclose(
            _np(ours({"scale": torch.from_numpy(scale)},
                     torch.from_numpy(x), 1e-6)),
            _np(theirs({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6)),
            rtol=1e-5, atol=1e-5)
    pos = np.arange(5)
    np.testing.assert_allclose(
        _np(L.rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)),
        _np(RL.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(L.sinusoidal_positions(37, 24)),
                               _np(RL.sinusoidal_positions(37, 24)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch, act", [("granite-3-8b", "swiglu"),
                                       ("gemma-2b", "geglu"),
                                       ("whisper-medium", "gelu")])
def test_mlp_activations_match_reference(arch, act):
    ref_cfg, cfg = _cfgs(arch)
    assert cfg.act == act
    params = RT.init_params(jax.random.PRNGKey(10), ref_cfg)
    p_ref = jax.tree.map(lambda a: a[0], params["segments"][0]["b0"]["mlp"])
    p = {k: torch.from_numpy(np.array(v)) for k, v in p_ref.items()}
    x = _randn(np.random.default_rng(11), 2, 6, cfg.d_model)
    np.testing.assert_allclose(_np(L.mlp(p, torch.from_numpy(x), cfg)),
                               _np(RL.mlp(p_ref, jnp.asarray(x), ref_cfg)),
                               rtol=1e-5, atol=1e-5)
