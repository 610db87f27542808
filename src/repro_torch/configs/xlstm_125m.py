"""xlstm-125m [ssm]: sLSTM + mLSTM blocks, alternating.  12L d_model=768
4H d_ff=0 (in-block projections) vocab=50304.  [arXiv:2405.04517]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="xlstm-125m",
    family="xlstm",
    source="arXiv:2405.04517",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    xlstm_pattern="msmsmsmsmsms",
    tie_embeddings=True,
)
