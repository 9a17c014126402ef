"""Shared layer library: norms, RoPE, GQA attention (direct / KV-chunked /
cached decode), gated MLPs, and capacity-based top-k MoE.

Counterpart of the reference's `models/layers.py`. All functions are pure
(params, inputs) → outputs, except that `attention_decode` writes the new
token's K/V into the cache it is given; parameters are plain dicts of
tensors created by the matching `init_*` function, each leaf with the
leading shape `lead` (a stacked segment's `(repeats,)`). Matmuls run in
cfg.dtype (bf16 by default) with float32 accumulation; where the
reference asks for a float32 result (`preferred_element_type`), both
operands are widened to float32 first, which gives the exact products
and float32 sums. Norms and softmax stay float32.

The reference's `shard(...)` annotations sit at its sites: the identity
without active rules (`sharding.shard`), a DTensor redistribution under
them. Both of its MoE dispatches are here, chosen by the module
constant `MOE_DISPATCH` as in the reference; they share `moe_route`.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.sharding import is_sharded, on_replicas, \
    per_head_shard, shard, split_dim, write_slot

_NEG = -1e30        # the reference's mask value


def cdtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _normal(g, shape, scale, dev) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=dev).mul_(scale)


def _mm32(eq: str, *xs) -> torch.Tensor:
    """einsum with a float32 result from operands of any float dtype."""
    return torch.einsum(eq, *(x.float() for x in xs))


# --------------------------------------------------------------------- norms
def init_norm(d: int, lead=(), dev=None) -> dict:
    return {"scale": torch.ones((*lead, d), device=dev)}


def rms_norm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    return (xc * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


# ---------------------------------------------------------------------- RoPE
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, hd) rotated pairwise; positions: broadcastable (.., S)."""
    hd = x.shape[-1]
    half = hd // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=x.device)
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), -ar / half)
    ang = positions[..., None].float() * freqs              # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int, dev=None,
                         offset: int = 0) -> torch.Tensor:
    """Whisper-style fixed positional embeddings (learned-pos stand-in),
    float32 (seq, d) for positions offset .. offset + seq - 1."""
    pos = (offset + torch.arange(seq, device=dev)).float()[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=dev)[None, :]
    ang = pos / torch.pow(torch.tensor(10_000.0, device=dev), 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


# ----------------------------------------------------------------- attention
def init_attention(g, cfg, lead=(), dev=None) -> dict:
    d, qd, kvd, hd = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.hd
    scale = d ** -0.5
    p = {
        "wq": _normal(g, (*lead, d, qd), scale, dev),
        "wk": _normal(g, (*lead, d, kvd), scale, dev),
        "wv": _normal(g, (*lead, d, kvd), scale, dev),
        "wo": _normal(g, (*lead, qd, d),
                      scale / max(2 * cfg.n_layers, 1) ** 0.5, dev),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_norm(hd, lead, dev)
        p["k_norm"] = init_norm(hd, lead, dev)
    return p


def _heads(y: torch.Tensor, axis: str) -> torch.Tensor:
    """A (B, S, heads·hd) projection sharded as its heads axis will be:
    under a mesh whose model axis does not divide the heads, DTensor
    cannot split a sharded last dim into (heads, hd), so it is replicated
    first, as GSPMD reshards it. The identity without rules."""
    return shard(y, "batch", None, axis)


def _qkv(p: dict, x: torch.Tensor, cfg, positions, *, use_rope: bool = True):
    """Project + reshape + (qk-norm) + RoPE. Returns q (B,S,KV,G,hd),
    k/v (B,S,KV,hd)."""
    B, S, _ = x.shape
    kv, hd = cfg.n_kv_heads, cfg.hd
    g = cfg.n_heads // kv
    dt = x.dtype
    # a head split of a sharded projection needs whole heads on each rank
    q = _heads(x @ p["wq"].to(dt), "heads").reshape(B, S, kv * g, hd)
    k = _heads(x @ p["wk"].to(dt), "kv").reshape(B, S, kv, hd)
    v = _heads(x @ p["wv"].to(dt), "kv").reshape(B, S, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_norm(p["k_norm"], k, cfg.norm_eps)
    if use_rope and positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = shard(q, "batch", None, "heads", None)
    k = shard(k, "batch", None, "kv", None)
    v = shard(v, "batch", None, "kv", None)
    return split_dim(q, 2, (kv, g)), k, v


def _attend_direct(q, k, v, mask) -> torch.Tensor:
    """q (B,S,KV,G,hd), k/v (B,T,KV,hd), mask (S,T) or None → (B,S,KV,G,hd).

    Grouped-head einsum keeps GQA KV unreplicated."""
    hd = q.shape[-1]
    scores = _mm32("bskgh,btkh->bkgst", q, k) * hd ** -0.5
    if mask is not None:
        scores = torch.where(mask, scores, _NEG)
    probs = torch.softmax(scores, dim=-1)
    return _mm32("bkgst,btkh->bskgh", probs.to(q.dtype), v).to(q.dtype)


def _attend_chunked(q, k, v, *, causal: bool, window: Optional[int],
                    chunk: int) -> torch.Tensor:
    """Online-softmax over KV chunks (flash-style streaming): memory is
    O(S·chunk) instead of O(S·T). Used whenever T > chunk. Ragged T pads
    KV to a chunk multiple; padded keys are masked out."""
    B, S, KV, G, hd = q.shape
    T = k.shape[1]
    pad = (-T) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    nc = (T + pad) // chunk
    dev = q.device
    qpos = torch.arange(S, device=dev)
    m = torch.full((B, KV, G, S), _NEG, device=dev)
    l = torch.zeros((B, KV, G, S), device=dev)
    acc = torch.zeros((B, KV, G, S, hd), device=dev)
    for ci in range(nc):
        kb = k[:, ci * chunk:(ci + 1) * chunk]
        vb = v[:, ci * chunk:(ci + 1) * chunk]
        kpos = ci * chunk + torch.arange(chunk, device=dev)
        s = _mm32("bskgh,btkh->bkgst", q, kb) * hd ** -0.5
        mask = (kpos < T)[None, :].expand(S, chunk)
        if causal:
            mask = mask & (qpos[:, None] >= kpos[None, :])
        if window is not None:
            mask = mask & (qpos[:, None] - kpos[None, :] < window)
        s = torch.where(mask, s, _NEG)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        pr = torch.exp(s - m_new[..., None])
        l = l * alpha + pr.sum(-1)
        acc = acc * alpha[..., None] + _mm32(
            "bkgst,btkh->bkgsh", pr.to(q.dtype), vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)          # (B,S,KV,G,hd)


def attention(p: dict, x: torch.Tensor, cfg, positions, *,
              causal: bool = True, window: Optional[int] = None,
              chunk: int = 1024, use_rope: bool = True) -> torch.Tensor:
    """Self-attention over a full sequence (train / prefill)."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions, use_rope=use_rope)
    if S <= chunk:
        mask = None
        if causal:
            pos = torch.arange(S, device=x.device)
            mask = pos[:, None] >= pos[None, :]
            if window is not None:
                mask = mask & (pos[:, None] - pos[None, :] < window)
        out = per_head_shard(_attend_direct, q, k, v, mask)
    else:
        out = per_head_shard(functools.partial(
            _attend_chunked, causal=causal, window=window, chunk=chunk),
            q, k, v)
    # whole heads first: the gradient of a q_dim sharding that splits
    # heads could not be viewed back as heads
    out = _heads(out.reshape(B, S, cfg.q_dim), "heads")
    out = shard(out, "batch", None, "qdim")
    return out @ p["wo"].to(x.dtype)


def attention_decode(p: dict, x: torch.Tensor, cfg, cache_k, cache_v,
                     cache_len: int, *, use_rope: bool = True):
    """One-token decode against a (ring-buffered) KV cache.

    x: (B, 1, d); cache_k/v: (B, T, KV, hd). `cache_len` is the number of
    tokens written BEFORE this step; the new token lands at slot
    `cache_len % T`, written into cache_k/v in place. For sliding-window
    layers the cache is sized T = window, and once wrapped every slot
    holds one of the last T positions — so validity is simply `slot ≤
    cache_len or wrapped`. Keys were RoPE'd at write time with absolute
    positions, so ring rotation never re-rotates. Returns (out, cache_k,
    cache_v).
    """
    B = x.shape[0]
    T = cache_k.shape[1]
    positions = torch.full((B, 1), cache_len, dtype=torch.int64,
                           device=x.device)
    q, k, v = _qkv(p, x, cfg, positions, use_rope=use_rope)
    slot = cache_len % T
    write_slot(cache_k, slot, k[:, 0].to(cache_k.dtype))
    write_slot(cache_v, slot, v[:, 0].to(cache_v.dtype))
    # where the KV heads cannot span the model axis the cache's TIME dim
    # is sharded over it ("kv_seq"): scores are computed on local slices
    # and the softmax and contraction reduce across them
    cache_k = shard(cache_k, "batch", "kv_seq", "kv", None)
    cache_v = shard(cache_v, "batch", "kv_seq", "kv", None)
    valid = torch.arange(T, device=x.device) <= cache_len
    if cache_len >= T:
        valid[:] = True

    def core(q, cache_k, cache_v, valid):
        scores = _mm32("bskgh,btkh->bkgst", q, cache_k.to(q.dtype)) \
            * cfg.hd ** -0.5
        scores = torch.where(valid, scores, _NEG)
        scores = shard(scores, "batch", "kv", None, None, "kv_seq")
        probs = torch.softmax(scores, dim=-1)
        return _mm32("bkgst,btkh->bskgh", probs.to(q.dtype),
                     cache_v.to(q.dtype))

    out = (core(q, cache_k, cache_v, valid) if is_sharded(cache_k, 1)
           else per_head_shard(core, q, cache_k, cache_v, valid))
    out = out.reshape(B, 1, cfg.q_dim).to(x.dtype)
    return out @ p["wo"].to(x.dtype), cache_k, cache_v


def cross_attention(p: dict, x: torch.Tensor, cfg, enc_k,
                    enc_v) -> torch.Tensor:
    """Decoder→encoder attention; enc_k/v precomputed (B, Te, KV, hd)."""
    B, S, _ = x.shape
    kv, hd = cfg.n_kv_heads, cfg.hd
    g = cfg.n_heads // kv
    q = split_dim(_heads(x @ p["wq"].to(x.dtype), "heads"), 2, (kv, g, hd))
    out = per_head_shard(_attend_direct, q, enc_k.to(x.dtype),
                         enc_v.to(x.dtype), None)
    return _heads(out.reshape(B, S, cfg.q_dim), "heads") \
        @ p["wo"].to(x.dtype)


def encoder_kv(p: dict, enc_out: torch.Tensor, cfg):
    """Precompute cross-attention K/V from encoder output."""
    B, Te, _ = enc_out.shape
    kv, hd = cfg.n_kv_heads, cfg.hd
    k = _heads(enc_out @ p["wk"].to(enc_out.dtype), "kv").reshape(
        B, Te, kv, hd)
    v = _heads(enc_out @ p["wv"].to(enc_out.dtype), "kv").reshape(
        B, Te, kv, hd)
    return k, v


# ----------------------------------------------------------------------- MLP
def init_mlp(g, cfg, d_ff: Optional[int] = None, lead=(), dev=None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    scale_in, scale_out = d ** -0.5, f ** -0.5
    p = {"w_down": _normal(g, (*lead, f, d),
                           scale_out / max(2 * cfg.n_layers, 1) ** 0.5, dev)}
    if cfg.act in ("swiglu", "geglu"):
        p["w_gate"] = _normal(g, (*lead, d, f), scale_in, dev)
    p["w_up"] = _normal(g, (*lead, d, f), scale_in, dev)
    return p


def gelu_tanh(z: torch.Tensor) -> torch.Tensor:
    return F.gelu(z, approximate="tanh")


def mlp(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    dt = x.dtype
    if cfg.act in ("swiglu", "geglu"):
        actfn = F.silu if cfg.act == "swiglu" else gelu_tanh
        h = actfn(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
    else:                                   # plain 2-matrix MLP (whisper)
        h = gelu_tanh(x @ p["w_up"].to(dt))
    h = shard(h, "batch", None, "hidden")
    return h @ p["w_down"].to(dt)


# ----------------------------------------------------------------------- MoE
# Two dispatch strategies (the same routing, positions and drops, from
# `moe_route`):
#   einsum  — t5x-style one-hot (G, E, C) dispatch/combine tensors. Simple,
#             but its traffic scales with G·E·C.
#   scatter — positional scatter into an (E·C, d) buffer and gather back:
#             O(G·K·d) traffic, no one-hot tensors.
MOE_DISPATCH = "scatter"


def init_moe(g, cfg, lead=(), dev=None) -> dict:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    si, so = d ** -0.5, f ** -0.5
    return {
        "router": _normal(g, (*lead, d, e), si, dev),
        "w_gate": _normal(g, (*lead, e, d, f), si, dev),
        "w_up": _normal(g, (*lead, e, d, f), si, dev),
        "w_down": _normal(g, (*lead, e, f, d),
                          so / max(2 * cfg.n_layers, 1) ** 0.5, dev),
    }


def top_k(x: torch.Tensor, k: int):
    """The k largest along the last axis, ties to the lower index (as
    `jax.lax.top_k`; `torch.topk` makes no such promise)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(p: dict, xg: torch.Tensor, cfg):
    """Routing of one token group xg (G, d): renormalized top-k gates
    (G, K) f32, each assignment's expert (G, K) and its destination row
    `expert·C + position` in the (E·C, d) expert buffer, E·C where the
    expert's capacity C is full (dropped). Positions fill slot 0 first,
    then slot 1, ..., each in token order.

    Under a mesh the stable sort, the cumulative sums across the group
    and the column writes have no DTensor sharding rule: the routing runs
    on replicas of xg and the router (`sharding.on_replicas`)."""
    G = xg.shape[0]
    E, K = cfg.n_experts, cfg.experts_per_tok
    C = max(int(G * K * cfg.capacity_factor / E), 1)

    def route(xg, router):
        logits = (xg @ router.to(xg.dtype)).float()
        probs = torch.softmax(logits, dim=-1)
        gate_vals, expert_idx = top_k(probs, K)              # (G, K)
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(-1, keepdim=True), min=1e-9)
        pos = torch.zeros((G, K), dtype=torch.int64, device=xg.device)
        fill = torch.zeros((E,), dtype=torch.int64, device=xg.device)
        for slot in range(K):                                # K ≤ 6
            onehot = F.one_hot(expert_idx[:, slot], E)
            p_slot = fill[None, :] + torch.cumsum(onehot, 0) - onehot
            pos[:, slot] = (p_slot * onehot).sum(1)
            fill = fill + (onehot * ((p_slot < C) & (onehot > 0))).sum(0)
        keep = pos < C
        dest = torch.where(keep, expert_idx * C + pos, E * C)
        return gate_vals, keep, dest

    gate_vals, keep, dest = on_replicas(route, xg, p["router"])
    return gate_vals, keep, dest, C


def _moe_group(p: dict, xg: torch.Tensor, cfg) -> torch.Tensor:
    """Capacity-based top-k dispatch of one token group xg (G, d) through
    one-hot tensors: dispatch (G, E, C) holds a 1 where a kept assignment
    lands, combine its renormalized gate; tokens go in and come out by
    einsums with f32 results (exact for dispatch: one token a slot)."""
    G, d = xg.shape
    E = cfg.n_experts
    dt = xg.dtype
    gate_vals, keep, dest, C = moe_route(p, xg, cfg)

    def tensors(gate_vals, keep, dest):              # no rule: one_hot
        hot = F.one_hot(dest, E * C + 1)[..., :E * C]        # (G, K, E·C)
        dispatch = hot.sum(1).to(dt).reshape(G, E, C)
        combine = (hot * (gate_vals * keep)[..., None]).sum(1).reshape(
            G, E, C)
        return dispatch, combine

    dispatch, combine = on_replicas(tensors, gate_vals, keep, dest)
    xin = _mm32("gec,gd->ecd", dispatch, xg).to(dt)
    xin = shard(xin, "experts", None, None)
    h = F.silu(torch.einsum("ecd,edf->ecf", xin, p["w_gate"].to(dt))) \
        * torch.einsum("ecd,edf->ecf", xin, p["w_up"].to(dt))
    h = shard(h, "experts", None, None)   # EP owns the axis
    y = torch.einsum("ecf,efd->ecd", h, p["w_down"].to(dt))
    return _mm32("gec,ecd->gd", combine.to(dt), y).to(dt)


def _moe_group_scatter(p: dict, xg: torch.Tensor, cfg) -> torch.Tensor:
    """Capacity-based top-k dispatch without one-hot tensors: each
    (token, slot) assignment scatters its row into an (E·C, d) expert
    buffer at `expert·C + pos` (overflow is dropped), experts run batched
    matmuls on the (E, C, d) buffer, and tokens gather their outputs back
    weighted by their gates (a dropped assignment weighs 0)."""
    G, d = xg.shape
    E, K = cfg.n_experts, cfg.experts_per_tok
    dt = xg.dtype
    gate_vals, keep, dest, C = moe_route(p, xg, cfg)
    flat = dest.reshape(-1)

    def scatter(xg, flat):
        # kept destinations are distinct: a plain scatter is the
        # reference's scatter-add into zeros; dropped assignments land on
        # one more row, which is cut off (no boolean mask, whose
        # data-dependent shape fake tensors cannot take)
        buf = torch.zeros((E * C + 1, d), dtype=dt, device=xg.device)
        buf[flat] = xg.repeat_interleave(K, dim=0)
        return buf[:E * C]

    buf = on_replicas(scatter, xg, flat)       # no DTensor rule
    xin = shard(buf.reshape(E, C, d), "experts", None, None)
    h = F.silu(torch.bmm(xin, p["w_gate"].to(dt))) \
        * torch.bmm(xin, p["w_up"].to(dt))
    h = shard(h, "experts", None, None)
    y = torch.bmm(h, p["w_down"].to(dt)).reshape(E * C, d)
    gathered = y[torch.clamp(flat, max=E * C - 1)].reshape(G, K, d)
    w = (gate_vals * keep).to(dt)
    return torch.bmm(w[:, None, :], gathered)[:, 0]


def moe(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Top-k MoE over (B, S, d): dispatch groups of ≤ moe_group_tokens,
    slicing the SEQUENCE dim only — (B, ns, Gs, d) — as the reference's
    scan does."""
    B, S, d = x.shape
    group = _moe_group_scatter if MOE_DISPATCH == "scatter" else _moe_group
    Gs = max(min(cfg.moe_group_tokens // max(B, 1), S), 1)
    if S % Gs != 0:
        Gs = S                              # ragged: single group
    ns = S // Gs
    if ns == 1:
        return group(p, x.reshape(B * S, d), cfg).reshape(B, S, d)
    xs = x.reshape(B, ns, Gs, d)
    out = [group(p, xs[:, i].reshape(B * Gs, d), cfg).reshape(B, Gs, d)
           for i in range(ns)]
    return torch.stack(out, dim=1).reshape(B, S, d)

