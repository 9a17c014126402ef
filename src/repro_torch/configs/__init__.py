"""Configurations of the port.

`paper_engine` holds the paper's rank-table defaults and its §5 dataset
scales. The architecture registry of the LM substrate: `--arch <id>`
resolves here. Each assigned architecture has one module with the exact
published config; `reduced(cfg)` derives the CPU smoke-test variant
(same family/topology, tiny dims). Copies of the reference's modules.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = (
    "llama4-scout-17b-a16e",
    "moonshot-v1-16b-a3b",
    "recurrentgemma-9b",
    "granite-3-8b",
    "qwen3-32b",
    "gemma-2b",
    "phi3-medium-14b",
    "chameleon-34b",
    "rwkv6-7b",
    "whisper-medium",
)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; choose from {ARCH_IDS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{arch_id.replace('-', '_')}")
    return mod.CONFIG


def reduced(cfg: ModelConfig, *, layers: int = 2) -> ModelConfig:
    """Smoke-test shrink: same family / block pattern / attention topology,
    small widths, tiny vocab. Keeps every structural trait (GQA ratio,
    qk-norm, MoE top-k, hybrid pattern, enc-dec) so the smoke test runs the
    same code paths as the full config."""
    g = max(cfg.n_heads // max(cfg.n_kv_heads, 1), 1)   # keep the GQA ratio
    kv = 1 if cfg.n_kv_heads == 1 else 2
    heads = kv * g
    if cfg.family == "rwkv":                 # wkv needs H·hd == d_model
        heads = kv = 64 // 16
    pat_len = len(cfg.block_pattern) or 1
    n_layers = max(layers, pat_len + (1 if cfg.family == "hybrid" else 0))
    changes = dict(
        n_layers=n_layers,
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=128,
        vocab=512,
        rwkv_lora_dim=8,
    )
    if cfg.family == "moe":
        changes.update(n_experts=max(cfg.n_experts // 8, 4),
                       experts_per_tok=min(cfg.experts_per_tok, 2),
                       moe_d_ff=64, moe_group_tokens=256)
    if cfg.family == "hybrid":
        changes.update(rnn_width=64, local_window=16)
    if cfg.family == "encdec":
        changes.update(n_enc_layers=2, enc_seq=24)
    return dataclasses.replace(cfg, **changes)


def reduced_depth(cfg: ModelConfig, *, layers: int = 2) -> ModelConfig:
    """Full widths, `reduced`'s layer counts (2; 4 for the hybrid; 2
    encoder layers for the enc-dec): the architecture at its published
    width with fewer layers, for a run on one card."""
    r = reduced(cfg, layers=layers)
    changes = dict(n_layers=r.n_layers)
    if cfg.family == "encdec":
        changes.update(n_enc_layers=r.n_enc_layers)
    return dataclasses.replace(cfg, **changes)
