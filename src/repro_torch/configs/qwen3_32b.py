"""qwen3-32b — dense GQA with qk-norm. [hf:Qwen/Qwen3-8B; hf]
64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,          # qwen3 fixes head_dim=128 (≠ d_model/n_heads)
    d_ff=25_600,
    vocab=151_936,
    act="swiglu",
    qk_norm=True,
)
