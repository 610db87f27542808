"""whisper-tiny [audio]: enc-dec backbone; conv/mel frontend is a stub
(input_specs provides precomputed frame embeddings).

4L (enc) + 4L (dec) d_model=384 6H (MHA kv=6) d_ff=1536 vocab=51865.
[arXiv:2212.04356]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-tiny",
    family="audio",
    source="arXiv:2212.04356",
    n_layers=4,            # decoder depth
    enc_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    act="gelu",
    enc_seq_frac=0.5,
)
