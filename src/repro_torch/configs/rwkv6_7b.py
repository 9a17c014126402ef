"""rwkv6-7b — Finch: attention-free, data-dependent decay.
[arXiv:2404.05892; hf]
32L d_model=4096 d_ff=14336 vocab=65536."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="rwkv",
    n_layers=32,
    d_model=4096,
    n_heads=32,            # WKV heads: hd = 128
    n_kv_heads=32,
    head_dim=128,
    d_ff=14_336,
    vocab=65_536,
    act="relu_sq",         # channel-mix uses relu²; act unused by tmix
)
