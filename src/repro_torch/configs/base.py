"""Configuration system of the port: models and input shapes.

The JAX package's ``repro/configs/base.py`` as data, kept here so the
port needs nothing of the JAX package: every assigned architecture gets
a ``ModelConfig`` (exact published dims) in
``src/repro_torch/configs/<arch>.py``; reduced smoke variants are
derived with ``smoke_variant``.  Input shapes are the four assigned
workload shapes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    arch_id: str = "unnamed"
    family: str = "dense"  # dense | moe | ssm | hybrid | audio | vlm | xlstm
    source: str = ""       # citation / model card

    # transformer backbone
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1000
    d_head: Optional[int] = None          # default: d_model // n_heads
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    use_bias: bool = False
    tie_embeddings: bool = False
    act: str = "silu"                     # silu (swiglu) | gelu (plain mlp)
    attention_window: Optional[int] = None  # sliding-window size (None = full)
    remat: bool = False                   # activation checkpointing per layer

    # MoE
    n_experts: int = 0                    # 0 = dense FFN
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    use_shared_expert: bool = True        # llama4-style shared expert
    router_aux_coef: float = 0.01

    # SSM / Mamba2
    ssm_state: int = 0                    # d_state (0 = no ssm layers)
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # hybrid (zamba2-style): shared attention block every `attn_every` ssm layers
    attn_every: int = 0                   # 0 = not hybrid

    # xLSTM
    xlstm_pattern: str = ""               # e.g. "msmsmsmsmsms" (m=mLSTM, s=sLSTM)

    # enc-dec (audio): n_layers is the DECODER depth; encoder depth below
    enc_layers: int = 0                   # 0 = decoder-only
    enc_seq_frac: float = 0.5             # fraction of shape.seq used by encoder

    # vlm
    n_patches: int = 0                    # stub patch-embedding prefix length

    def __post_init__(self):
        if self.d_head is None:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError(
                f"{self.arch_id}: q heads {self.n_heads} not divisible by "
                f"kv heads {self.n_kv_heads}")

    # -- derived -----------------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter count (analytic; used for roofline MODEL_FLOPS) ---------
    def param_count(self, active_only: bool = False) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hq, hk, hd = self.n_heads, self.n_kv_heads, self.d_head
        attn = d * hq * hd + 2 * d * hk * hd + hq * hd * d
        if self.act == "silu":
            ffn = 3 * d * f
        else:
            ffn = 2 * d * f
        norms = 2 * d

        if self.family == "xlstm":
            per = _xlstm_layer_params(self)
            total = self.n_layers * per + v * d + d
            return int(total)
        if self.family in ("ssm", "hybrid") and self.ssm_state:
            mamba = _mamba2_layer_params(self)
            if self.family == "hybrid" and self.attn_every:
                n_attn_calls = self.n_layers // self.attn_every
                shared = attn + ffn + norms + 2 * d * d  # concat-proj
                total = self.n_layers * (mamba + d) + shared
            else:
                total = self.n_layers * (mamba + d)
            total += v * d + d + (0 if self.tie_embeddings else v * d)
            return int(total)

        per_layer = attn + norms
        if self.n_experts > 0:
            per_layer += self.n_experts * ffn + d * self.n_experts
            if self.use_shared_expert:
                per_layer += ffn
        else:
            per_layer += ffn
        total = self.n_layers * per_layer
        if self.enc_layers:
            # encoder self-attn + mlp, decoder gets extra cross-attn
            total += self.enc_layers * (attn + ffn + norms)
            total += self.n_layers * (attn + d)
        total += v * d + d
        if not self.tie_embeddings:
            total += v * d
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts + shared)."""
        if self.n_experts == 0:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        ffn = 3 * d * f if self.act == "silu" else 2 * d * f
        inactive = (self.n_experts - self.moe_top_k) * ffn * self.n_layers
        return self.param_count() - int(inactive)


def _mamba2_layer_params(cfg: ModelConfig) -> int:
    d, di, ds = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = cfg.ssm_heads
    in_proj = d * (2 * di + 2 * ds + nh)
    conv = (di + 2 * ds) * cfg.ssm_conv
    out_proj = di * d
    extra = nh * 2 + di  # A, D, dt_bias-ish + norm
    return in_proj + conv + out_proj + extra


def _xlstm_layer_params(cfg: ModelConfig) -> int:
    # mirrors models/xlstm.py init exactly
    d = cfg.d_model
    hd = d // cfg.n_heads
    # mLSTM block: wq,wk,wv + i/f gates + o-gate + out proj
    m = 3 * d * d + 2 * d * cfg.n_heads + d * d + d * d
    # sLSTM block: input proj (4 gates) + block-diag recurrent + out proj
    s = 4 * d * d + 4 * cfg.n_heads * hd * hd + d * d
    return (m + s) // 2 + 3 * d


# ---------------------------------------------------------------------------
# Workload shapes (assigned)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


# ---------------------------------------------------------------------------
# Reduced smoke variants (2 layers, d_model <= 512, <= 4 experts)
# ---------------------------------------------------------------------------


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    d_model = min(cfg.d_model, 256)
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    kw = dict(
        n_layers=2,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_head=d_model // n_heads,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_headdim=32 if cfg.ssm_state else cfg.ssm_headdim,
        ssm_chunk=16 if cfg.ssm_state else cfg.ssm_chunk,
        attn_every=1 if cfg.attn_every else 0,
        enc_layers=2 if cfg.enc_layers else 0,
        n_patches=8 if cfg.n_patches else 0,
        xlstm_pattern=cfg.xlstm_pattern[:2] if cfg.xlstm_pattern else "",
        attention_window=(min(cfg.attention_window, 64)
                          if cfg.attention_window else None),
    )
    return cfg.with_(**kw)
