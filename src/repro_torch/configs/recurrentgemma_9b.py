"""recurrentgemma-9b — RG-LRU + local attention, 1:2 pattern.
[arXiv:2402.19427; unverified]
38L d_model=4096 16H (GQA kv=1) d_ff=12288 vocab=256000."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12_288,
    vocab=256_000,
    act="geglu",
    block_pattern=("rglru", "rglru", "local_attn"),
    rnn_width=4096,
    local_window=2048,
)
