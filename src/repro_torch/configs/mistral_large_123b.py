"""mistral-large-123b [dense]: 88L d_model=12288 96H (GQA kv=8)
d_ff=28672 vocab=32768.  [hf:mistralai/Mistral-Large-Instruct-2407]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="mistral-large-123b",
    family="dense",
    source="hf:mistralai/Mistral-Large-Instruct-2407",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=32768,
)
