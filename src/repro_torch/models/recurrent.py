"""Recurrent mixers: RG-LRU (RecurrentGemma/Griffin) and RWKV-6 (Finch).

Counterpart of the reference's `models/recurrent.py`:
  * RG-LRU's linear recurrence h_t = a_t·h_{t-1} + b_t runs as a
    sequential float32 scan over time for prefill (the reference runs a
    log-depth associative scan; both sum the same terms, in another
    association) and a single step for decode. Gate projections are
    dense (R, R) rather than Griffin's block-diagonal, as in the
    reference.
  * RWKV-6's data-dependent-decay WKV runs CHUNKED (GLA-style): intra-
    chunk pairwise decays are exact in log space (all exponents ≤ 0 ⇒
    stable), inter-chunk state flows chunk by chunk. Decode is the exact
    O(1) recurrence.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _normal, gelu_tanh, init_norm
from repro_torch.models.sharding import per_shard, shard


# ------------------------------------------------------------------- RG-LRU
_RG_C = 8.0     # Griffin's fixed temperature on the recurrence gate


def init_rglru_block(g, cfg, lead=(), dev=None) -> dict:
    d, r, cw = cfg.d_model, cfg.lru_width, cfg.conv_width
    si, sr = d ** -0.5, r ** -0.5
    return {
        "w_x": _normal(g, (*lead, d, r), si, dev),
        "w_gate": _normal(g, (*lead, d, r), si, dev),
        "w_out": _normal(g, (*lead, r, d),
                         sr / max(2 * cfg.n_layers, 1) ** 0.5, dev),
        "conv_w": _normal(g, (*lead, cw, r), 0.1, dev),
        "conv_b": torch.zeros((*lead, r), device=dev),
        "w_a": _normal(g, (*lead, r, r), sr, dev),
        "b_a": torch.zeros((*lead, r), device=dev),
        "w_i": _normal(g, (*lead, r, r), sr, dev),
        "b_i": torch.zeros((*lead, r), device=dev),
        # Λ init so σ(Λ) ∈ ~(0.9, 0.999): a stable long-memory band.
        "lam": torch.empty((*lead, r), device=dev).uniform_(2.0, 6.0,
                                                            generator=g),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time. u (B,S,R), w (cw,R)."""
    cw = w.shape[0]
    upad = F.pad(u, (0, 0, cw - 1, 0))
    out = torch.zeros_like(u)
    for i in range(cw):                      # cw = 4: unrolled taps
        out = out + upad[:, i:i + u.shape[1], :] * w[cw - 1 - i]
    return out + b


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as `jax.nn.softplus` computes it (logaddexp(x, 0))."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _rglru_coeffs(p: dict, u: torch.Tensor):
    """Per-step (a_t, b_t) of the RG-LRU recurrence (float32)."""
    uf = u.float()
    # f32 products (a bf16 compute copy of the gates widens, as jnp
    # promotes it)
    rec_gate = torch.sigmoid(uf @ p["w_a"].float() + p["b_a"])
    in_gate = torch.sigmoid(uf @ p["w_i"].float() + p["b_i"])
    log_a = -_RG_C * _softplus(p["lam"]) * rec_gate           # ≤ 0
    a = torch.exp(log_a)
    # sqrt(1 - a²) via expm1 for precision near a ≈ 1
    scale = torch.sqrt(-torch.expm1(2.0 * log_a))
    b = scale * (in_gate * uf)
    return a, b


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t·h_{t-1} + b_t over dim 1 from h_0 = 0, sequentially."""
    h = torch.empty_like(b)                                  # (B,S,R) f32
    state = torch.zeros_like(b[:, 0])
    for t in range(b.shape[1]):
        state = a[:, t] * state + b[:, t]
        h[:, t] = state
    return h


def rglru_block(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Full-sequence RG-LRU block (prefill). x: (B,S,D)."""
    dt = x.dtype
    u = x @ p["w_x"].to(dt)
    u = shard(u, "batch", None, "rnn")
    u = _causal_conv(u, p["conv_w"].to(dt), p["conv_b"].to(dt))
    a, b = _rglru_coeffs(p, u)
    # independent along the batch and the width: each rank scans its own
    h = per_shard(_linear_scan, ("b.r", "b.r"), "b.r", a, b)
    gate = gelu_tanh((x @ p["w_gate"].to(dt)).float())
    y = (h * gate).to(dt)
    y = shard(y, "batch", None, "rnn")
    return y @ p["w_out"].to(dt)


def rglru_decode(p: dict, x: torch.Tensor, cfg, state: dict
                 ) -> Tuple[torch.Tensor, dict]:
    """One-token step. x: (B,1,D); state: {h: (B,R) f32, conv: (B,cw-1,R)}."""
    dt = x.dtype
    u = (x @ p["w_x"].to(dt))[:, 0]                           # (B,R)
    hist = torch.cat([state["conv"], u[:, None]], dim=1)      # (B,cw,R)
    # _causal_conv convention: out[t] = Σ_j u[t-j]·w[j], i.e. w[0] applies
    # to the CURRENT token. hist is oldest-first, so flip the taps.
    w = p["conv_w"].to(dt).flip(0)
    conv = torch.einsum("bcr,cr->br", hist.float(), w.float()).to(dt) \
        + p["conv_b"].to(dt)
    a, b = _rglru_coeffs(p, conv[:, None])
    h = a[:, 0] * state["h"] + b[:, 0]                        # (B,R) f32
    gate = gelu_tanh((x[:, 0] @ p["w_gate"].to(dt)).float())
    y = ((h * gate).to(dt) @ p["w_out"].to(dt))[:, None]
    return y, {"h": h, "conv": hist[:, 1:]}


# -------------------------------------------------------------------- RWKV-6
def init_rwkv_tmix(g, cfg, lead=(), dev=None) -> dict:
    d, lora = cfg.d_model, cfg.rwkv_lora_dim
    s = d ** -0.5
    full = lambda v: torch.full((*lead, d), v, device=dev)
    return {
        "mu_r": full(0.5), "mu_k": full(0.5), "mu_v": full(0.5),
        "mu_g": full(0.5), "mu_w": full(0.5),
        "w0": full(-1.0),                             # base decay logits
        "u": _normal(g, (*lead, d), 0.3, dev),        # bonus
        "lora_a": _normal(g, (*lead, d, lora), s, dev),
        "lora_b": _normal(g, (*lead, lora, d), 0.01, dev),
        "w_r": _normal(g, (*lead, d, d), s, dev),
        "w_k": _normal(g, (*lead, d, d), s, dev),
        "w_v": _normal(g, (*lead, d, d), s, dev),
        "w_g": _normal(g, (*lead, d, d), s, dev),
        "w_o": _normal(g, (*lead, d, d),
                       s / max(2 * cfg.n_layers, 1) ** 0.5, dev),
        "ln_out": init_norm(d, lead, dev),
    }


def init_rwkv_cmix(g, cfg, lead=(), dev=None) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": torch.full((*lead, d), 0.5, device=dev),
        "mu_r": torch.full((*lead, d), 0.5, device=dev),
        "w_k": _normal(g, (*lead, d, f), d ** -0.5, dev),
        "w_v": _normal(g, (*lead, f, d),
                       f ** -0.5 / max(2 * cfg.n_layers, 1) ** 0.5, dev),
        "w_r": _normal(g, (*lead, d, d), d ** -0.5, dev),
    }


def _shift(x: torch.Tensor) -> torch.Tensor:
    """Token shift: x_{t-1} (zeros at t=0). x: (B,S,D)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _head_group_norm(scale: torch.Tensor, y: torch.Tensor, H: int,
                     eps: float) -> torch.Tensor:
    """RWKV's GroupNorm(H groups): RMS-normalize each head's hd channels,
    then apply the per-channel (d,) scale. y: (..., d)."""
    shp = y.shape
    yh = y.reshape(*shp[:-1], H, shp[-1] // H).float()
    var = (yh * yh).mean(-1, keepdim=True)
    yh = yh * torch.rsqrt(var + eps)
    return (yh.reshape(shp) * scale).to(y.dtype)


def _tmix_inputs(p: dict, x: torch.Tensor, xx: torch.Tensor, cfg):
    """r,k,v,g projections + per-step log-decay (B,S,H,hd) from ddlerp."""
    dt = x.dtype
    B, S, d = x.shape
    H, hd = cfg.n_heads, cfg.hd
    mix = lambda mu: x + (xx - x) * mu.to(dt)
    heads = lambda y: shard(y, "batch", None, "heads").reshape(B, S, H, hd)
    r = heads(mix(p["mu_r"]) @ p["w_r"].to(dt))
    k = heads(mix(p["mu_k"]) @ p["w_k"].to(dt))
    v = heads(mix(p["mu_v"]) @ p["w_v"].to(dt))
    g = F.silu(mix(p["mu_g"]) @ p["w_g"].to(dt))
    xw = mix(p["mu_w"]).float()
    dlog = torch.tanh(xw @ p["lora_a"].float()) \
        @ p["lora_b"].float()                                # (B,S,d) f32
    logw = -torch.exp(p["w0"] + dlog)                         # ≤ 0, f32
    return r, k, v, g, logw.reshape(B, S, H, hd)


def _wkv_chunk(r, k, v, logw, u, s0):
    """Exact WKV for one chunk, log-space-stable.

    r,k,v: (B,H,L,hd) f32; logw: (B,H,L,hd) ≤ 0; u: (H,hd); s0: (B,H,hd,hd).
    Returns (y (B,H,L,hd), s_new). All pairwise decay exponents are ≤ 0.
    """
    L = r.shape[2]
    cum = torch.cumsum(logw, dim=2)                           # (B,H,L,hd)
    cum_prev = cum - logw                                     # Σ_{j<t}
    # inter-chunk: y += (r_t ⊙ exp(cum_{t-1})) · S0
    rdec = r * torch.exp(cum_prev)
    y = torch.einsum("bhld,bhde->bhle", rdec, s0)
    # intra-chunk: scores_ts = Σ_d r_td k_sd exp(cum_{t-1,d} − cum_{s,d}), s<t
    expo = cum_prev[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,H,L,L,hd)
    tril = torch.tril(torch.ones((L, L), dtype=torch.bool, device=r.device),
                      diagonal=-1)
    dec = torch.where(tril[:, :, None],
                      torch.exp(torch.clamp(expo, max=0.0)), 0.0)
    scores = (r[:, :, :, None, :] * k[:, :, None, :, :] * dec).sum(-1)
    y = y + torch.einsum("bhts,bhse->bhte", scores, v)
    # current-token bonus: (r_t ⊙ u ⊙ k_t) · v_t
    bonus = (r * u[None, :, None, :] * k).sum(-1, keepdim=True)
    y = y + bonus * v
    # state: S_L = diag(exp(cum_L)) S0 + Σ_s (k_s ⊙ exp(cum_L − cum_s)) v_sᵀ
    kdec = k * torch.exp(cum[:, :, -1:, :] - cum)
    s_new = torch.exp(cum[:, :, -1, :, None]) * s0 + torch.einsum(
        "bhsd,bhse->bhde", kdec, v)
    return y, s_new


def wkv_chunked(r, k, v, logw, u, s0, chunk: int = 64):
    """(B,H,S,hd) inputs → (y, s_final), chunk by chunk over S."""
    S = r.shape[2]
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"seq {S} not divisible by chunk {L}")
    ys, s = [], s0
    for c0 in range(0, S, L):
        part = lambda t: t[:, :, c0:c0 + L]
        y, s = _wkv_chunk(part(r), part(k), part(v), part(logw), u, s)
        ys.append(y)
    return torch.cat(ys, dim=2), s


_WKV = ("bh..",) * 4 + ("h.", "bh..")     # r, k, v, logw, u, s0


def rwkv_tmix(p: dict, x: torch.Tensor, cfg, chunk: int = 64
              ) -> torch.Tensor:
    """Full-sequence RWKV-6 time mix. x: (B,S,D)."""
    B, S, d = x.shape
    H, hd = cfg.n_heads, cfg.hd
    dt = x.dtype
    r, k, v, g, logw = _tmix_inputs(p, x, _shift(x), cfg)
    tr = lambda t: t.transpose(1, 2).float()
    s0 = torch.zeros((B, H, hd, hd), device=x.device)
    # independent along the batch and the heads: each rank scans its own
    y = per_shard(lambda *a: wkv_chunked(*a, chunk)[0], _WKV,
                  "bh..", tr(r), tr(k), tr(v), tr(logw),
                  p["u"].reshape(H, hd), s0)
    y = y.transpose(1, 2).reshape(B, S, d)                    # (B,S,D)
    y = _head_group_norm(p["ln_out"]["scale"], y, H, cfg.norm_eps)
    return (y.to(dt) * g) @ p["w_o"].to(dt)


def rwkv_tmix_decode(p: dict, x: torch.Tensor, cfg, s: torch.Tensor,
                     x_prev: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token RWKV-6 step — the exact O(1) recurrence.

    x: (B,1,D); s: (B,H,hd,hd) f32 WKV state; x_prev: (B,D) token shift.
    Returns (out, s_new, x_new).
    """
    B, _, d = x.shape
    H, hd = cfg.n_heads, cfg.hd
    xx = x_prev[:, None, :].to(x.dtype)
    r, k, v, g, logw = _tmix_inputs(p, x, xx, cfg)
    rf, kf, vf = (t[:, 0].reshape(B, H, hd).float() for t in (r, k, v))
    w = torch.exp(logw[:, 0].reshape(B, H, hd))               # decay (0,1)
    u = p["u"].reshape(H, hd)

    def step(rf, kf, vf, w, u, s):
        kv = kf[..., :, None] * vf[..., None, :]              # (B,H,hd,hd)
        y = torch.einsum("bhd,bhde->bhe", rf, s + u[None, :, :, None] * kv)
        return y, w[..., None] * s + kv

    # independent along the batch and the heads: each rank steps its own
    y, s_new = per_shard(step, ("bh.", "bh.", "bh.", "bh.", "h.", "bh.."),
                         ("bh.", "bh.."), rf, kf, vf, w, u, s)
    y = _head_group_norm(p["ln_out"]["scale"], y.reshape(B, 1, d), H,
                         cfg.norm_eps)
    out = (y.to(x.dtype) * g) @ p["w_o"].to(x.dtype)
    return out, s_new, x[:, 0]


def rwkv_cmix(p: dict, x: torch.Tensor, cfg,
              x_prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Channel mix. Full-seq when x_prev is None, else one-token decode."""
    dt = x.dtype
    xx = _shift(x) if x_prev is None else x_prev[:, None, :].to(dt)
    mix = lambda mu: x + (xx - x) * mu.to(dt)
    kk = torch.square(torch.relu(mix(p["mu_k"]) @ p["w_k"].to(dt)))
    kk = shard(kk, "batch", None, "hidden")
    rr = torch.sigmoid(mix(p["mu_r"]) @ p["w_r"].to(dt))
    return rr * (kk @ p["w_v"].to(dt))
