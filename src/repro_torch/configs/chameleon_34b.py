"""chameleon-34b — early-fusion VLM, VQ image tokens share the vocab.
[arXiv:2405.09818; unverified]
48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.
The modality frontend is a STUB per the assignment: image patches arrive
as VQ token ids inside the ordinary token stream."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="dense",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22_016,
    vocab=65_536,
    act="swiglu",
    qk_norm=True,          # chameleon stabilizes with qk-norm
)
