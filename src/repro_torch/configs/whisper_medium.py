"""whisper-medium — enc-dec, conv frontend STUB (precomputed frame
embeddings via input_specs). [arXiv:2212.04356; unverified]
24L enc + 24L dec, d_model=1024 16H (kv=16) d_ff=4096 vocab=51865."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=51_865,
    act="gelu",
    enc_seq=1500,
)
