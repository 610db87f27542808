"""yi-9b [dense]: llama-arch GQA.  48L d_model=4096 32H (GQA kv=4)
d_ff=11008 vocab=64000.  [arXiv:2403.04652]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="yi-9b",
    family="dense",
    source="arXiv:2403.04652",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
)
