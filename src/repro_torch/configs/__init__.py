"""Config registry: the 10 assigned architectures, the JAX package's
``repro/configs`` as data (the port keeps its own copy).

``get_config(arch_id)`` returns the exact published dims; pass
``smoke=True`` for the reduced CPU-testable variant (2 layers, d_model<=256,
<=4 experts) used by the per-arch smoke tests.
"""
from __future__ import annotations

import importlib
from typing import Dict, Optional

from repro_torch.configs.base import (LONG_500K, PREFILL_32K, SHAPES, TRAIN_4K,
                                DECODE_32K, ModelConfig, ShapeConfig,
                                smoke_variant)

_MODULES = {
    "zamba2-1.2b": "zamba2_1_2b",
    "whisper-tiny": "whisper_tiny",
    "mistral-large-123b": "mistral_large_123b",
    "yi-9b": "yi_9b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "command-r-35b": "command_r_35b",
    "granite-20b": "granite_20b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "xlstm-125m": "xlstm_125m",
    "pixtral-12b": "pixtral_12b",
}

ARCH_IDS = list(_MODULES)


def get_config(arch_id: str, smoke: bool = False,
               shape: Optional[ShapeConfig] = None) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; available: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    cfg: ModelConfig = mod.CONFIG
    if shape is not None:
        cfg = adapt_for_shape(cfg, shape)
    if smoke:
        cfg = smoke_variant(cfg)
    return cfg


def adapt_for_shape(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """Shape-dependent config adjustments.

    ``long_500k`` requires sub-quadratic attention: every attention-bearing
    arch switches to a sliding window; SSM/xLSTM layers are
    unaffected (O(1) state).
    """
    if shape.name == "long_500k" and cfg.family != "xlstm":
        return cfg.with_(attention_window=8192)
    return cfg


def all_configs(smoke: bool = False) -> Dict[str, ModelConfig]:
    return {a: get_config(a, smoke=smoke) for a in ARCH_IDS}
