"""moonshot-v1-16b-a3b — kimi/moonlight MoE, 64e top-6.
[hf:moonshotai/Moonlight-16B-A3B; hf]
48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64e top-6."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab=163_840,
    act="swiglu",
    n_experts=64,
    experts_per_tok=6,
    moe_d_ff=1408,
)
