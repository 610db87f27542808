"""command-r-35b [dense]: GQA, no-bias.  40L d_model=8192 64H (GQA kv=8)
d_ff=22528 vocab=256000.  [hf:CohereForAI/c4ai-command-r-v01]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="command-r-35b",
    family="dense",
    source="hf:CohereForAI/c4ai-command-r-v01",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    use_bias=False,
    tie_embeddings=True,
)
