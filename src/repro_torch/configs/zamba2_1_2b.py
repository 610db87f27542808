"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention block.

38L d_model=2048 32H (MHA kv=32) d_ff=8192 vocab=32000 ssm_state=64.
[arXiv:2411.15242]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-1.2b",
    family="hybrid",
    source="arXiv:2411.15242",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=128,
    attn_every=6,          # shared attention block applied every 6 mamba layers
    tie_embeddings=True,
)
