"""The port's training loss (`repro_torch.models.transformer.lm_loss`, its
chunked cross-entropy, remat and the einsum MoE dispatch) against the
live reference, on the CPU, at `reduced()` sizes.

For each of the ten architectures the reference's parameters
(`init_params(PRNGKey(0))`) and batch (its `TokenPipeline`, plus frames
for the enc-dec) cross through `convert`; with remat "none":

- at float32, the loss within rtol 1e-5 and every gradient leaf within
  1e-4 of that leaf's largest reference magnitude, or of 1e-4 of the
  whole gradient's largest where the leaf's is smaller than that: a leaf
  four orders below the rest is rounding-dominated (llama4's router at
  one expert a token, whose renormalized gate is 1 and whose gradient is
  zero but for rounding; recurrentgemma's recurrence gate, whose
  reference sums its scan in another association);
- at the config's own bf16, the loss within 0.05 and the gradients
  within 5 % relative L1 over all leaves (the reference's criteria in
  tests/test_train_substrate.py).

Pieces: `_chunked_ce`'s (lse, label logit) against the reference's at f32
(rtol 1e-5); the chunked loss against the dense one (5e-3, gradients
within 5 % of each leaf's largest, tests/test_chunked_ce.py's bounds);
what the chunked CE keeps for its backward (saved-tensor hooks: less
than one (B, S, V) f32 tensor, where the dense CE keeps more); remat
"nothing", "dots" and "none", and the per-layer `unbind` against indexing
each layer, all bitwise equal gradients; the einsum MoE dispatch against
the reference's and against the port's scatter dispatch. The reference
runs under `jit`, one trace per (arch, dtype). Two intra-op threads.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data.pipeline import PipelineConfig as RefPipelineConfig
from repro.data.pipeline import TokenPipeline as RefTokenPipeline
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch import configs, convert
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.model import Model
from repro_torch.train.trainer import _value_and_grad

ARCHS = ref_configs.ARCH_IDS
B, S = 2, 8


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _cfgs(arch, dtype="float32", **changes):
    changes = dict(dtype=dtype, remat="none", **changes)
    ref = dataclasses.replace(
        ref_configs.reduced(ref_configs.get_config(arch)), **changes)
    port = dataclasses.replace(
        configs.reduced(configs.get_config(arch)), **changes)
    return ref, port


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ref_batch(cfg, seq=S, batch=B):
    out = dict(RefTokenPipeline(RefPipelineConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch)).batch_at(0))
    if cfg.family == "encdec":
        rng = np.random.default_rng(3)
        out["frames"] = jnp.asarray(rng.normal(
            size=(batch, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    return out


_ref_vg = jax.jit(jax.value_and_grad(RT.lm_loss), static_argnames="cfg")


@pytest.fixture(scope="module")
def reference():
    runs = {}

    def get(arch, dtype):
        if (arch, dtype) not in runs:
            cfg, _ = _cfgs(arch, dtype)
            params = RT.init_params(jax.random.PRNGKey(0), cfg)
            batch = _ref_batch(cfg)
            loss, grads = _ref_vg(params, batch, cfg=cfg)
            runs[(arch, dtype)] = {
                "params": jax.tree.map(np.asarray, params),
                "batch": jax.tree.map(np.asarray, batch),
                "loss": float(loss),
                "grads": dict(_flat(jax.tree.map(np.asarray, grads)))}
        return runs[(arch, dtype)]

    return get


def _port_loss_and_grads(ref, arch, dtype):
    _, cfg = _cfgs(arch, dtype)
    params = convert.model_params_from_reference(ref["params"], cfg,
                                                 device="cpu")
    batch = convert.batch_from_reference(ref["batch"], device="cpu")
    loss, grads = _value_and_grad(Model(cfg), params, batch, bf16=False)
    return loss, dict(_flat(grads))


def _leaves_close(want: dict, got: dict, rel=1e-4):
    """Every leaf within `rel` of its largest magnitude, or of `rel` of
    the whole gradient's largest where the leaf's is smaller."""
    assert set(got) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        g = _np(got[path])
        assert g.shape == w.shape, path
        scale = max(float(np.abs(w).max()), rel * top)
        err = float(np.abs(g - w).max())
        assert err <= rel * scale, (path, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_f32(reference, arch):
    ref = reference(arch, "float32")
    loss, grads = _port_loss_and_grads(ref, arch, "float32")
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)
    _leaves_close(ref["grads"], grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_bf16(reference, arch):
    ref = reference(arch, "bfloat16")
    loss, grads = _port_loss_and_grads(ref, arch, "bfloat16")
    assert abs(float(loss) - ref["loss"]) < 0.05
    gn = sum(float(np.abs(w).sum()) for w in ref["grads"].values())
    dn = sum(float(np.abs(_np(grads[p]) - w).sum())
             for p, w in ref["grads"].items())
    assert dn < 0.05 * gn, (dn, gn)


# -------------------------------------------------------------- chunked CE
def test_chunked_ce_raw_math_matches_reference():
    """lse / label logit of the chunk loop equal the reference's scan at
    f32 (no bf16 rounding), and the dense computation."""
    rng = np.random.default_rng(2)
    Bq, Sq, D, V = 2, 5, 16, 64
    x = rng.normal(size=(Bq, Sq, D)).astype(np.float32)
    head = rng.normal(size=(D, V)).astype(np.float32)
    labels = rng.integers(0, V, (Bq, Sq))
    want_lse, want_ll = RT._chunked_ce(jnp.asarray(x), jnp.asarray(head),
                                       jnp.asarray(labels), n_chunks=4)
    lse, ll = T._chunked_ce(torch.from_numpy(x), torch.from_numpy(head),
                            torch.from_numpy(labels), 4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=1e-5)
    np.testing.assert_allclose(ll.numpy(), np.asarray(want_ll), rtol=1e-5)
    logits = torch.from_numpy(x) @ torch.from_numpy(head)
    np.testing.assert_allclose(lse.numpy(),
                               torch.logsumexp(logits, -1).numpy(),
                               rtol=1e-5)


@pytest.mark.parametrize("n_chunks", [2, 8])
def test_chunked_ce_matches_dense_loss_and_grads(n_chunks):
    cfg0 = dataclasses.replace(configs.reduced(configs.get_config(
        "granite-3-8b")), n_layers=2, vocab=512, remat="none")
    cfg1 = dataclasses.replace(cfg0, vocab_chunks=n_chunks)
    params = T.init_params(0, cfg0, "cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(512, (2, 16), generator=g),
             "labels": torch.randint(512, (2, 16), generator=g)}
    batch["labels"][0, :3] = -1                      # masked positions
    l0, g0 = _value_and_grad(Model(cfg0), params, batch, bf16=False)
    l1, g1 = _value_and_grad(Model(cfg1), params, batch, bf16=False)
    assert abs(float(l0) - float(l1)) < 5e-3
    for (path, a), (_, b) in zip(_flat(g0), _flat(g1)):
        scale = float(a.abs().max()) + 1e-9
        assert float((a - b).abs().max()) / scale < 0.05, path


def _saved(fn):
    """fn() and the tensors its graph keeps for the backward."""
    kept = []

    def pack(t):
        kept.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, kept


def test_chunked_ce_keeps_less_than_one_logits_tensor():
    Bq, Sq, D, V = 2, 64, 16, 512
    g = torch.Generator().manual_seed(5)
    x = torch.randn((Bq, Sq, D), generator=g).to(torch.bfloat16)
    head = torch.randn((D, V), generator=g).to(torch.bfloat16)
    x.requires_grad_()
    head.requires_grad_()
    labels = torch.randint(V, (Bq, Sq), generator=g)
    logits_bytes = Bq * Sq * V * 4
    nbytes = lambda kept: sum(t.numel() * t.element_size() for t in kept)
    (lse, ll), kept = _saved(lambda: T._chunked_ce(x, head, labels, 8))
    assert nbytes(kept) < logits_bytes, nbytes(kept)
    (lse - ll).sum().backward()
    assert x.grad.shape == x.shape and head.grad.shape == head.shape

    def dense():
        lg = (x @ head).float()
        return torch.logsumexp(lg, -1), torch.gather(lg, -1,
                                                     labels[..., None])
    _, kept = _saved(dense)
    assert nbytes(kept) >= logits_bytes

    # the whole loss: no saved tensor of per-token logits, chunk or full,
    # where the dense loss keeps one (V = 1,000: its chunk, 125, is no
    # width of the model)
    V = 1000
    labels = torch.randint(V, (Bq, Sq), generator=g)
    cfg = dataclasses.replace(configs.reduced(configs.get_config(
        "gemma-2b")), vocab=V, remat="none")
    params = T.init_params(0, cfg, "cpu")
    for p in T.leaves(params):
        p.requires_grad_()
    batch = {"tokens": labels, "labels": labels}
    logit_like = lambda kept: [
        tuple(t.shape) for t in kept if t.dim() == 3
        and tuple(t.shape[:2]) == (Bq, Sq) and t.shape[-1] in (V, V // 8)]
    _, kept = _saved(lambda: T.lm_loss(
        params, batch, dataclasses.replace(cfg, vocab_chunks=8)))
    assert logit_like(kept) == []
    _, kept = _saved(lambda: T.lm_loss(params, batch, cfg))
    assert (Bq, Sq, V) in logit_like(kept)


# ------------------------------------------------------------------- remat
def _grads(cfg, params, batch):
    _, g = _value_and_grad(Model(cfg), params, batch, bf16=True)
    return dict(_flat(g))


@pytest.mark.parametrize("arch", ["gemma-2b", "moonshot-v1-16b-a3b",
                                  "recurrentgemma-9b", "rwkv6-7b",
                                  "whisper-medium"])
def test_remat_policies_and_unbind_give_bitwise_equal_grads(arch):
    base = configs.reduced(configs.get_config(arch))
    params = T.init_params(3, base, "cpu")
    g = torch.Generator().manual_seed(4)
    batch = {"tokens": torch.randint(base.vocab, (2, 16), generator=g),
             "labels": torch.randint(base.vocab, (2, 16), generator=g)}
    if base.family == "encdec":
        batch["frames"] = torch.randn((2, base.enc_seq, base.d_model),
                                      generator=g)
    got = {r: _grads(dataclasses.replace(base, remat=r), params, batch)
           for r in ("none", "nothing", "dots")}
    # the layers taken one by one by indexing (the serving path's
    # `layer`), in place of one unbind a segment
    unbind = T._unbind
    T._unbind = lambda seg, repeats: [T.layer(seg, r)
                                      for r in range(repeats)]
    try:
        got["indexed"] = _grads(dataclasses.replace(base, remat="none"),
                                params, batch)
    finally:
        T._unbind = unbind
    assert T._unbind is unbind
    for name in ("nothing", "dots", "indexed"):
        for path, want in got["none"].items():
            assert torch.equal(got[name][path], want), (name, path)


def test_remat_leaves_serving_unchanged():
    """Without autograd the body runs as it is: no checkpoint."""
    cfg = configs.reduced(configs.get_config("granite-3-8b"))
    body = lambda h, p: h
    assert T._remat(body, cfg) is not body          # "nothing" records
    with torch.no_grad():
        assert T._remat(body, cfg) is body
    assert T._remat(body, dataclasses.replace(cfg, remat="none")) is body


# --------------------------------------------------------------------- MoE
@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
def test_einsum_dispatch_matches_reference_and_scatter(capacity_factor):
    """One group at f32: the port's one-hot dispatch against the
    reference's `_moe_group` (capacity 1.25 drops tokens, 8 none), and
    against the port's scatter dispatch."""
    ref_cfg, cfg = _cfgs("moonshot-v1-16b-a3b",
                         capacity_factor=capacity_factor)
    p_ref = RL.init_moe(jax.random.PRNGKey(0), ref_cfg)
    rng = np.random.default_rng(9)
    xg = rng.normal(size=(40, cfg.d_model)).astype(np.float32)
    want = np.asarray(RL._moe_group(p_ref, jnp.asarray(xg), ref_cfg))
    p = {k: torch.from_numpy(np.array(v)) for k, v in p_ref.items()}
    x = torch.from_numpy(xg)
    got = L._moe_group(p, x, cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(),
                               L._moe_group_scatter(p, x, cfg).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e",
                                  "moonshot-v1-16b-a3b"])
def test_moe_dispatch_switch_keeps_loss_and_grads(arch):
    """`layers.MOE_DISPATCH = "einsum"` trains the same model as the
    default scatter dispatch: loss within 1e-5, gradients as in the f32
    parity test."""
    _, cfg = _cfgs(arch)
    params = T.init_params(1, cfg, "cpu")
    g = torch.Generator().manual_seed(2)
    batch = {"tokens": torch.randint(cfg.vocab, (2, 16), generator=g),
             "labels": torch.randint(cfg.vocab, (2, 16), generator=g)}
    assert L.MOE_DISPATCH == "scatter"
    l0, g0 = _value_and_grad(Model(cfg), params, batch, bf16=False)
    try:
        L.MOE_DISPATCH = "einsum"
        l1, g1 = _value_and_grad(Model(cfg), params, batch, bf16=False)
    finally:
        L.MOE_DISPATCH = "scatter"
    assert L.MOE_DISPATCH == "scatter"
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-5)
    _leaves_close({p: _np(a) for p, a in _flat(g0)}, dict(_flat(g1)))
