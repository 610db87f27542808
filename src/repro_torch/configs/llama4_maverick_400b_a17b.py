"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128 experts top-1 + shared expert.
[hf:meta-llama/Llama-4-Scout-17B-16E (family card)]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama4-maverick-400b-a17b",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    n_experts=128,
    moe_top_k=1,
    use_shared_expert=True,
)
