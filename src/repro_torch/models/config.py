"""Model configuration for the 10 assigned architecture families.

One frozen dataclass covers every family via the `family` discriminator and
`block_pattern` (for the hybrid). Exact published hyper-parameters live in
`repro_torch/configs/<arch>.py`; this module owns structure and derived
sizes. A copy of the reference's `models/config.py`: the same fields,
defaults (bf16 activations) and derived sizes.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | rwkv | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 → d_model // n_heads
    act: str = "swiglu"         # swiglu | geglu | gelu (plain 2-matrix MLP)
    qk_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"     # activation compute dtype
    # --- MoE ---
    n_experts: int = 0
    experts_per_tok: int = 0
    moe_d_ff: int = 0           # per-expert hidden width
    capacity_factor: float = 1.25
    moe_group_tokens: int = 65_536   # global tokens per dispatch group
    # --- hybrid (RecurrentGemma / Griffin) ---
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rglru","rglru","local_attn")
    rnn_width: int = 0          # 0 → d_model
    conv_width: int = 4
    local_window: int = 2048
    # --- RWKV-6 ---
    rwkv_lora_dim: int = 64
    # --- enc-dec (Whisper) ---
    n_enc_layers: int = 0
    enc_seq: int = 1500         # stub audio frames (conv frontend precomputed)
    # --- remat policy for train_step ---
    remat: str = "nothing"      # nothing | dots | none(off)
    # --- §Perf H5: chunked-vocab CE (0/1 = off) ---
    vocab_chunks: int = 0

    def __post_init__(self):
        if self.family not in ("dense", "moe", "hybrid", "rwkv", "encdec"):
            raise ValueError(f"unknown family {self.family!r}")
        if self.family == "moe" and not (self.n_experts and
                                         self.experts_per_tok):
            raise ValueError("moe family needs n_experts/experts_per_tok")
        if self.family == "hybrid" and not self.block_pattern:
            raise ValueError("hybrid family needs block_pattern")

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd

    @property
    def lru_width(self) -> int:
        return self.rnn_width or self.d_model

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch supports 500k-token contexts (SSM/linear/local)."""
        return self.family in ("rwkv", "hybrid")

    @property
    def has_decoder(self) -> bool:
        """Decode shapes apply (everything here autoregresses; encoder-only
        archs would return False)."""
        return True

    def segments(self) -> Tuple[Tuple[Tuple[str, ...], int], ...]:
        """Layer stacking plan: ((pattern, repeats), ...). Each segment scans
        `repeats` times over a body applying `pattern` blocks in order, so
        the traced HLO is O(#segments), not O(n_layers)."""
        if self.family == "hybrid":
            p = len(self.block_pattern)
            full, rem = divmod(self.n_layers, p)
            segs = []
            if full:
                segs.append((tuple(self.block_pattern), full))
            if rem:
                segs.append((tuple(self.block_pattern[:rem]), 1))
            return tuple(segs)
        block = {"dense": "attn_mlp", "moe": "attn_moe", "rwkv": "rwkv",
                 "encdec": "dec_block"}[self.family]
        return (((block,), self.n_layers),)

    def enc_segments(self) -> Tuple[Tuple[Tuple[str, ...], int], ...]:
        if self.family != "encdec":
            return ()
        return ((("enc_block",), self.n_enc_layers),)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell: what gets lowered in the dry-run."""
    name: str                   # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                   # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPE_CELLS = (
    ShapeCell("train_4k", "train", 4_096, 256),
    ShapeCell("prefill_32k", "prefill", 32_768, 32),
    ShapeCell("decode_32k", "decode", 32_768, 128),
    ShapeCell("long_500k", "decode", 524_288, 1),
)


def cell_applicable(cfg: ModelConfig, cell: ShapeCell) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) per the assignment's skip rules."""
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 500k decode needs sub-quadratic " \
                      "attention (skip noted in DESIGN.md)"
    if cell.is_decode and not cfg.has_decoder:
        return False, "encoder-only arch has no decode step"
    return True, ""
