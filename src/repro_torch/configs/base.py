"""Model configuration of the port: the fields of the JAX package's
``ModelConfig`` (``repro/configs/base.py``) that the port's models read,
with the same defaults, so the port needs nothing of the JAX package.

A field joins with the slice whose model reads it; the published
architecture configs, input shapes and smoke variants come with the
model zoo (ROADMAP item 16).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str = "unnamed"              # names the config in errors
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    d_head: Optional[int] = None          # default: d_model // n_heads
    rope_theta: float = 10000.0
    act: str = "silu"                     # silu (swiglu) | gelu (plain mlp)
    norm_eps: float = 1e-5                # RMSNorm's eps (mlstm_block)

    def __post_init__(self):
        if self.d_head is None:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError(
                f"{self.arch_id}: q heads {self.n_heads} not divisible by "
                f"kv heads {self.n_kv_heads}")

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads
