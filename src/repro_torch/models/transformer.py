"""Backbone assembly: stacked layer segments for all 10 architectures.

Counterpart of the reference's `models/transformer.py`. Parameters and
caches are plain nested dicts of tensors in the reference's layout:
layers are stacked per `cfg.segments()` (see ModelConfig), each segment
holding its pattern's blocks with a leading `repeats` axis. A forward
pass unbinds each segment into its layers once (views; under autograd
the backward stacks their gradients in one go) and loops over them; under
autograd each layer's body is rematerialized as `cfg.remat` says.

Public surface:
  init_params(generator, cfg, device)  — f32 master parameters
  abstract_params(cfg)                 — the same tree on the meta device
  forward_hidden / forward_logits      — train/prefill hidden states, logits
  lm_loss(params, batch, cfg)          — masked CE (+ z-loss), dense or
                                         chunked over the vocabulary
  encode(params, frames)               — enc-dec encoder (whisper stub input)
  init_cache / fill_cross_kv / decode_step — one-token serving with caches
"""
from __future__ import annotations

import functools
from typing import Optional, Union

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import is_sharded, on_replicas, \
    pick_last, shard, take_rows


def _norm(cfg):
    return L.layer_norm if cfg.family == "encdec" else L.rms_norm


# ------------------------------------------------------------------ blocks
def _init_block(block: str, g, cfg: ModelConfig, lead, dev) -> dict:
    d = cfg.d_model
    if block in ("attn_mlp", "local_attn", "enc_block"):
        return {"ln1": L.init_norm(d, lead, dev),
                "attn": L.init_attention(g, cfg, lead, dev),
                "ln2": L.init_norm(d, lead, dev),
                "mlp": L.init_mlp(g, cfg, lead=lead, dev=dev)}
    if block == "attn_moe":
        return {"ln1": L.init_norm(d, lead, dev),
                "attn": L.init_attention(g, cfg, lead, dev),
                "ln2": L.init_norm(d, lead, dev),
                "moe": L.init_moe(g, cfg, lead, dev)}
    if block == "rwkv":
        return {"ln1": L.init_norm(d, lead, dev),
                "tmix": R.init_rwkv_tmix(g, cfg, lead, dev),
                "ln2": L.init_norm(d, lead, dev),
                "cmix": R.init_rwkv_cmix(g, cfg, lead, dev)}
    if block == "rglru":
        return {"ln1": L.init_norm(d, lead, dev),
                "rglru": R.init_rglru_block(g, cfg, lead, dev),
                "ln2": L.init_norm(d, lead, dev),
                "mlp": L.init_mlp(g, cfg, lead=lead, dev=dev)}
    if block == "dec_block":
        return {"ln1": L.init_norm(d, lead, dev),
                "attn": L.init_attention(g, cfg, lead, dev),
                "lnx": L.init_norm(d, lead, dev),
                "xattn": L.init_attention(g, cfg, lead, dev),
                "ln2": L.init_norm(d, lead, dev),
                "mlp": L.init_mlp(g, cfg, lead=lead, dev=dev)}
    raise ValueError(f"unknown block {block!r}")


def _resid(y: torch.Tensor) -> torch.Tensor:
    """A sublayer's output as the residual stream holds it: sharded on the
    batch, replicated on the model axis (the embedding's layout). Under a
    mesh this is the all-reduce after a row-parallel product; without it
    DTensor would carry partial sums into the next norm. The identity
    without rules."""
    return shard(y, "batch", None, None)


def _apply_block(block: str, p: dict, x: torch.Tensor, cfg: ModelConfig,
                 positions, *, enc_kv=None) -> torch.Tensor:
    """Full-sequence (prefill) application of one block."""
    norm = _norm(cfg)
    if block in ("attn_mlp", "attn_moe", "local_attn"):
        window = cfg.local_window if block == "local_attn" else None
        x = x + _resid(L.attention(p["attn"], norm(p["ln1"], x,
                                                   cfg.norm_eps), cfg,
                                   positions, causal=True, window=window))
        h = norm(p["ln2"], x, cfg.norm_eps)
        ff = L.moe(p["moe"], h, cfg) if block == "attn_moe" else \
            L.mlp(p["mlp"], h, cfg)
        return x + _resid(ff)
    if block == "rwkv":
        x = x + _resid(R.rwkv_tmix(p["tmix"], norm(p["ln1"], x,
                                                   cfg.norm_eps), cfg))
        return x + _resid(R.rwkv_cmix(p["cmix"], norm(p["ln2"], x,
                                                      cfg.norm_eps), cfg))
    if block == "rglru":
        x = x + _resid(R.rglru_block(p["rglru"], norm(p["ln1"], x,
                                                      cfg.norm_eps), cfg))
        return x + _resid(L.mlp(p["mlp"], norm(p["ln2"], x, cfg.norm_eps),
                                cfg))
    if block == "enc_block":
        x = x + _resid(L.attention(p["attn"], norm(p["ln1"], x,
                                                   cfg.norm_eps), cfg,
                                   None, causal=False, use_rope=False))
        return x + _resid(L.mlp(p["mlp"], norm(p["ln2"], x, cfg.norm_eps),
                                cfg))
    if block == "dec_block":
        x = x + _resid(L.attention(p["attn"], norm(p["ln1"], x,
                                                   cfg.norm_eps), cfg,
                                   None, causal=True, use_rope=False))
        # enc_kv carries the raw encoder output; each decoder layer projects
        # it with its own wk/wv (whisper-style per-layer cross attention).
        ek, ev = L.encoder_kv(p["xattn"], enc_kv, cfg)
        x = x + _resid(L.cross_attention(p["xattn"], norm(p["lnx"], x,
                                                          cfg.norm_eps),
                                         cfg, ek, ev))
        return x + _resid(L.mlp(p["mlp"], norm(p["ln2"], x, cfg.norm_eps),
                                cfg))
    raise ValueError(f"unknown block {block!r}")


# ---------------------------------------------------------------- stacking
def layer(tree, r: int):
    """Layer r of a stacked segment: every leaf's slice r (views)."""
    if isinstance(tree, dict):
        return {k: layer(v, r) for k, v in tree.items()}
    return tree[r]


def leaves(tree):
    """Every tensor of a parameter or cache tree (dicts and lists)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of `tree` and the matching leaves of `rest`
    (trees of the same structure: dicts, lists, tuples and NamedTuples)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)


def _unbind(seg, repeats: int) -> list:
    """A stacked segment as `repeats` per-layer trees of views: one
    `unbind(0)` per leaf, so that under autograd the backward stacks the
    layers' gradients once (indexing each layer would allocate and add a
    zero tensor the size of the whole leaf per layer)."""
    if isinstance(seg, dict):
        parts = {k: _unbind(v, repeats) for k, v in seg.items()}
        return [{k: p[r] for k, p in parts.items()} for r in range(repeats)]
    return list(seg.unbind(0))


def _init_segment(g, pattern, repeats, cfg, dev) -> dict:
    return {f"b{i}": _init_block(b, g, cfg, (repeats,), dev)
            for i, b in enumerate(pattern)}


# what remat "dots" keeps: the outputs of the products (the counterpart of
# `jax.checkpoint_policies.checkpoint_dots`); everything else is recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg):
    """`fn` under `cfg.remat` when autograd records: "nothing" keeps only
    the layer's inputs and recomputes its body in the backward, "dots"
    also keeps the products' outputs, "none" is plain autograd. Without
    autograd (serving) `fn` runs as it is."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _save_dots)
    elif cfg.remat != "nothing":
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    return functools.partial(_ckpt.checkpoint, fn, use_reentrant=False,
                             **kw)


def _apply_segments(params_segs, segments, x, cfg, positions, *,
                    enc_kv=None) -> torch.Tensor:
    for seg_params, (pattern, repeats) in zip(params_segs, segments):
        def body(h, layer_p, pattern=pattern):
            for i, b in enumerate(pattern):
                h = _apply_block(b, layer_p[f"b{i}"], h, cfg, positions,
                                 enc_kv=enc_kv)
            return h

        body = _remat(body, cfg)
        for layer_p in _unbind(seg_params, repeats):
            x = body(x, layer_p)
    return x


# ------------------------------------------------------------------ params
def init_params(generator: Union[int, torch.Generator], cfg: ModelConfig,
                device=None) -> dict:
    """Random f32 master parameters on `device` (the CUDA card unless the
    caller passes device='cpu'), drawn from `generator` (a seed or a
    torch.Generator on that device). The reference's `jax.random` draws
    cannot be matched: to compute on the reference's parameters, carry
    them across with `repro_torch.convert.model_params_from_reference`."""
    dev = resolve_device(device)
    g = generator
    if isinstance(g, int):
        g = torch.Generator(device=dev)
        g.manual_seed(generator)
    return _init_params(g, cfg, dev)


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree on the meta device: every leaf's shape and
    dtype, nothing allocated (checkpoint templates)."""
    return _init_params(None, cfg, torch.device("meta"))


def _init_params(g, cfg: ModelConfig, dev) -> dict:
    d = cfg.d_model
    p = {"embed": {"tok": L._normal(g, (cfg.vocab, d), 0.02, dev)}}
    p["segments"] = [_init_segment(g, pattern, repeats, cfg, dev)
                     for pattern, repeats in cfg.segments()]
    p["final_norm"] = L.init_norm(d, dev=dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = {"w": L._normal(g, (d, cfg.vocab), d ** -0.5, dev)}
    if cfg.family == "encdec":
        p["enc_in"] = {"w": L._normal(g, (d, d), d ** -0.5, dev)}
        p["enc_segments"] = [_init_segment(g, pattern, repeats, cfg, dev)
                             for pattern, repeats in cfg.enc_segments()]
        p["enc_norm"] = L.init_norm(d, dev=dev)
    return p


# ----------------------------------------------------------------- forward
def encode(params: dict, frames: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """Whisper encoder over stub frame embeddings (B, enc_seq, D)."""
    dt = L.cdtype(cfg)
    x = frames.to(dt) @ params["enc_in"]["w"].to(dt)
    x = x + L.sinusoidal_positions(x.shape[1], cfg.d_model,
                                   x.device).to(dt)
    x = _apply_segments(params["enc_segments"], cfg.enc_segments(), x, cfg,
                        None)
    return L.layer_norm(params["enc_norm"], x, cfg.norm_eps)


def _embed(params, tokens, cfg, pos_offset: int = 0) -> torch.Tensor:
    dt = L.cdtype(cfg)
    x = take_rows(params["embed"]["tok"], tokens).to(dt)
    if cfg.family == "encdec":
        # absolute (sinusoidal) decoder positions; decode offsets by the
        # cache length so step t uses position t, not 0.
        x = x + L.sinusoidal_positions(tokens.shape[1], cfg.d_model,
                                       x.device, offset=pos_offset).to(dt)
    return shard(x, "batch", None, None)


def _logits(params, x, cfg) -> torch.Tensor:
    head = params["embed"]["tok"].T if cfg.tie_embeddings else \
        params["lm_head"]["w"]
    return shard(x @ head.to(x.dtype), "batch", None, "vocab")


def forward_hidden(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
                   frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Final normed hidden states (B, S, D)."""
    x = _embed(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    enc_kv = None
    if cfg.family == "encdec":
        # raw encoder output; each decoder block projects it with its own
        # wk/wv (whisper-style per-layer cross attention)
        enc_kv = encode(params, frames, cfg)
    x = _apply_segments(params["segments"], cfg.segments(), x, cfg,
                        positions, enc_kv=enc_kv)
    return _norm(cfg)(params["final_norm"], x, cfg.norm_eps)


def forward_logits(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
                   frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence logits (training / prefill). tokens: (B, S) integer."""
    return _logits(params, forward_hidden(params, tokens, cfg,
                                          frames=frames), cfg)


# ------------------------------------------------------------------- loss
class _ChunkedCE(torch.autograd.Function):
    """Online-logsumexp cross-entropy over vocab chunks. The forward keeps
    its inputs and (lse, label logit) only; the backward recomputes each
    chunk's logits, turns them into (softmax − one-hot) and accumulates
    the gradients of x and of the head chunk by chunk, so no (B, S, V)
    tensor lives at any time. Products widen both operands to f32 (exact
    products, f32 sums: the reference's `preferred_element_type`); the
    gradients sum over chunks in f32 and are rounded once to the inputs'
    dtypes."""

    @staticmethod
    def forward(ctx, x, head, labels, n_chunks):
        B, S = labels.shape
        V = head.shape[1]
        Vc = V // n_chunks
        xf = x.float()
        m = torch.full((B, S), -1e30, device=x.device)
        se = torch.zeros((B, S), device=x.device)
        ll = torch.zeros((B, S), device=x.device)
        for ci in range(n_chunks):
            logits = xf @ head[:, ci * Vc:(ci + 1) * Vc].float()
            m_new = torch.maximum(m, logits.amax(-1))
            se = se * torch.exp(m - m_new) + torch.exp(
                logits - m_new[..., None]).sum(-1)
            local = labels - ci * Vc
            inside = (local >= 0) & (local < Vc)
            picked = torch.gather(logits, -1, torch.clamp(
                local, 0, Vc - 1)[..., None])[..., 0]
            ll = ll + torch.where(inside, picked, 0.0)
            m = m_new
        lse = m + torch.log(torch.clamp(se, min=1e-30))
        ctx.n_chunks = n_chunks
        ctx.save_for_backward(x, head, labels, lse)
        return lse, ll

    @staticmethod
    def backward(ctx, g_lse, g_ll):
        x, head, labels, lse = ctx.saved_tensors
        n_chunks = ctx.n_chunks
        V = head.shape[1]
        Vc = V // n_chunks
        xf = x.float()
        g_lse = torch.zeros_like(lse) if g_lse is None else g_lse
        g_ll = torch.zeros_like(lse) if g_ll is None else g_ll
        dx = torch.zeros_like(xf)
        dhead = torch.empty(head.shape, dtype=torch.float32,
                            device=head.device)
        for ci in range(n_chunks):
            hc = head[:, ci * Vc:(ci + 1) * Vc].float()
            logits = xf @ hc                                # (B, S, Vc)
            dlog = torch.exp(logits - lse[..., None]) * g_lse[..., None]
            local = labels - ci * Vc
            inside = (local >= 0) & (local < Vc)
            # one index a row: no two adds meet
            dlog.scatter_add_(-1, torch.clamp(local, 0, Vc - 1)[..., None],
                              torch.where(inside, g_ll, 0.0)[..., None])
            dx += dlog @ hc.T
            dhead[:, ci * Vc:(ci + 1) * Vc] = torch.einsum(
                "bsd,bsv->dv", xf, dlog)
        return dx.to(x.dtype), dhead.to(head.dtype), None, None


def _chunked_ce(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                n_chunks: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Online-logsumexp cross-entropy over vocab chunks (§Perf H5).

    x (B, S, D), head (D, V) with V divisible by `n_chunks`, labels
    (B, S) in [0, V). Never materializes the full (B, S, V) f32 logits,
    in the forward or the backward. Returns (lse, label_logit), both
    (B, S) f32. Under a mesh it runs on replicas of its inputs
    (`sharding.on_replicas`): its chunks slice the vocabulary, which the
    head's DTensor shards, and its gathers reduce partial sums that
    DTensor cannot index."""
    return on_replicas(lambda x, head, labels: _ChunkedCE.apply(
        x, head, labels, n_chunks), x, head, labels)


def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """logsumexp over the last dim. Where a mesh shards that dim (the
    vocabulary), as max + log Σ exp(x − max), whose max and sum reduce
    across the shards (jax.nn.logsumexp's form); DTensor would gather the
    whole (B, S, V) logits onto every rank for `torch.logsumexp`."""
    if not is_sharded(logits, logits.ndim - 1):
        return torch.logsumexp(logits, dim=-1)
    m = logits.amax(-1, keepdim=True).detach()
    return (m + torch.log(torch.exp(logits - m).sum(-1, keepdim=True)))[
        ..., 0]


def lm_loss(params: dict, batch: dict, cfg: ModelConfig,
            z_loss: float = 1e-4) -> torch.Tensor:
    """Masked next-token cross-entropy. batch: tokens/labels (B,S)
    integer, labels < 0 are masked; encdec adds frames (B,enc_seq,D).
    With cfg.vocab_chunks > 1 dividing the vocabulary the (B,S,V) f32
    logits never materialize. Returns a 0-d f32 tensor."""
    x = forward_hidden(params, batch["tokens"], cfg,
                       frames=batch.get("frames"))
    labels = batch["labels"]
    mask = (labels >= 0).float()
    safe = torch.clamp(labels, min=0)
    head = (params["embed"]["tok"].T if cfg.tie_embeddings
            else params["lm_head"]["w"])
    if cfg.vocab_chunks > 1 and cfg.vocab % cfg.vocab_chunks == 0:
        lse, ll = _chunked_ce(x.to(torch.bfloat16), head.to(torch.bfloat16),
                              safe, cfg.vocab_chunks)
    else:
        logits = (x @ head.to(x.dtype)).float()
        logits = shard(logits, "batch", None, "vocab")
        lse = _logsumexp(logits)
        ll = pick_last(logits, safe)
    nll = (lse - ll) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = nll.sum() / denom
    if z_loss:
        loss = loss + z_loss * ((lse * mask) ** 2).sum() / denom
    return loss


# ------------------------------------------------------------------ decode
def _init_block_cache(block: str, batch: int, cache_len: int,
                      cfg: ModelConfig, dt, lead, dev) -> dict:
    kv, hd = cfg.n_kv_heads, cfg.hd
    z = lambda *shape, dtype=dt: torch.zeros((*lead, *shape), dtype=dtype,
                                             device=dev)
    if block in ("attn_mlp", "attn_moe", "enc_block"):
        return {"k": z(batch, cache_len, kv, hd),
                "v": z(batch, cache_len, kv, hd)}
    if block == "dec_block":
        # self-attn KV plus per-layer cross-attention KV over encoder frames
        return {"k": z(batch, cache_len, kv, hd),
                "v": z(batch, cache_len, kv, hd),
                "xk": z(batch, cfg.enc_seq, kv, hd),
                "xv": z(batch, cfg.enc_seq, kv, hd)}
    if block == "local_attn":
        T = min(cache_len, cfg.local_window)
        return {"k": z(batch, T, kv, hd), "v": z(batch, T, kv, hd)}
    if block == "rwkv":
        return {"s": z(batch, cfg.n_heads, hd, hd, dtype=torch.float32),
                "xt": z(batch, cfg.d_model), "xc": z(batch, cfg.d_model)}
    if block == "rglru":
        return {"h": z(batch, cfg.lru_width, dtype=torch.float32),
                "conv": z(batch, cfg.conv_width - 1, cfg.lru_width)}
    raise ValueError(block)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device=None) -> dict:
    """Decode cache mirroring the segment structure (each leaf with the
    leading `repeats` axis), plus `len`, the tokens written so far."""
    dev = resolve_device(device)
    dt = L.cdtype(cfg)
    segs = [{f"b{i}": _init_block_cache(b, batch, cache_len, cfg, dt,
                                        (repeats,), dev)
             for i, b in enumerate(pattern)}
            for pattern, repeats in cfg.segments()]
    return {"segments": segs, "len": 0}


def fill_cross_kv(params: dict, cache: dict, enc_out: torch.Tensor,
                  cfg: ModelConfig) -> dict:
    """Project encoder output into every decoder layer's cross-KV cache
    (run once per request before decoding), in place."""
    for seg_params, seg_cache, (pattern, repeats) in zip(
            params["segments"], cache["segments"], cfg.segments()):
        for i, b in enumerate(pattern):
            if b != "dec_block":
                continue
            c = seg_cache[f"b{i}"]
            for r in range(repeats):
                k, v = L.encoder_kv(layer(seg_params[f"b{i}"]["xattn"], r),
                                    enc_out, cfg)
                c["xk"][r] = k.to(c["xk"].dtype)
                c["xv"][r] = v.to(c["xv"].dtype)
    return cache


def _decode_block(block: str, p: dict, x: torch.Tensor, cfg, cache: dict,
                  cache_len: int) -> torch.Tensor:
    """One block of one decode step; its cache slice is updated in
    place."""
    norm = _norm(cfg)
    if block in ("attn_mlp", "attn_moe", "local_attn", "dec_block"):
        h = norm(p["ln1"], x, cfg.norm_eps)
        out, _, _ = L.attention_decode(
            p["attn"], h, cfg, cache["k"], cache["v"], cache_len,
            use_rope=(cfg.family != "encdec"))
        x = x + out
        if block == "dec_block":
            x = x + L.cross_attention(
                p["xattn"], norm(p["lnx"], x, cfg.norm_eps), cfg,
                cache["xk"], cache["xv"])
        h2 = norm(p["ln2"], x, cfg.norm_eps)
        ff = L.moe(p["moe"], h2, cfg) if block == "attn_moe" else \
            L.mlp(p["mlp"], h2, cfg)
        return x + ff
    if block == "rwkv":
        h = norm(p["ln1"], x, cfg.norm_eps)
        out, s_new, xt_new = R.rwkv_tmix_decode(p["tmix"], h, cfg,
                                                cache["s"], cache["xt"])
        x = x + out
        h2 = norm(p["ln2"], x, cfg.norm_eps)
        out2 = R.rwkv_cmix(p["cmix"], h2, cfg, x_prev=cache["xc"])
        cache["s"].copy_(s_new)
        cache["xt"].copy_(xt_new)
        cache["xc"].copy_(h2[:, 0])
        return x + out2
    if block == "rglru":
        h = norm(p["ln1"], x, cfg.norm_eps)
        out, st = R.rglru_decode(p["rglru"], h, cfg, cache)
        cache["h"].copy_(st["h"])
        cache["conv"].copy_(st["conv"])
        x = x + out
        return x + L.mlp(p["mlp"], norm(p["ln2"], x, cfg.norm_eps), cfg)
    raise ValueError(block)


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                cfg: ModelConfig):
    """One serving step: tokens (B, 1) → (logits (B,1,V), cache).

    Each layer's cache slice is updated in place; the returned cache
    shares the tensors of the one given, with `len` advanced by one (the
    one given keeps its old `len` and must not be decoded from again).
    """
    cache_len = cache["len"]
    x = _embed(params, tokens, cfg, pos_offset=cache_len)
    for seg_params, seg_cache, (pattern, repeats) in zip(
            params["segments"], cache["segments"], cfg.segments()):
        for r in range(repeats):
            layer_p, layer_c = layer(seg_params, r), layer(seg_cache, r)
            for i, b in enumerate(pattern):
                x = _decode_block(b, layer_p[f"b{i}"], x, cfg,
                                  layer_c[f"b{i}"], cache_len)
    x = _norm(cfg)(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, x, cfg), dict(cache, len=cache_len + 1)
