"""pixtral-12b [vlm]: mistral-nemo decoder consuming pixtral-ViT patch
embeddings (ViT frontend is a stub; input_specs provides patch embeddings).

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.
[hf:mistralai/Pixtral-12B-2409]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="pixtral-12b",
    family="vlm",
    source="hf:mistralai/Pixtral-12B-2409",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    n_patches=1024,
)
