"""Grouped-query attention with RoPE and sliding windows, full sequence.

Two implementations share one math definition, as in the JAX package's
``models/attention.py``:

  * ``naive``  — materializes the (S, S) score matrix;
  * ``kernel`` — ``repro_torch.kernels.ops.flash_attention``: the
                 hand-written CUDA flash-attention kernel on the card (the
                 JAX package's ``"pallas"``), its plain version on the CPU.

Parameters are a dict of (d_in, d_out) matrices ``wq``, ``wk``, ``wv``,
``wo``; activations are (B, S, H, hd) between the projections, as in the
JAX package.  The JAX package's ``chunked`` implementation, its
KV-cache decode and its cross-attention decode come with the model zoo
(ROADMAP item 16) and raise ``NotImplementedError`` here.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import apply_rope, dense_init

Params = Dict[str, torch.Tensor]
_LATER = "comes with the model zoo: ROADMAP item 16"


def init_attention(generator: torch.Generator, cfg: ModelConfig) -> Params:
    d, hq, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    return {"wq": dense_init(generator, d, hq * hd),
            "wk": dense_init(generator, d, hk * hd),
            "wv": dense_init(generator, d, hk * hd),
            "wo": dense_init(generator, hq * hd, d)}


# ---------------------------------------------------------------------------
# mask helpers
# ---------------------------------------------------------------------------

def _causal_window_bias(q_pos: torch.Tensor, k_pos: torch.Tensor,
                        causal: bool,
                        window: Optional[int]) -> torch.Tensor:
    """Additive bias (..., Sq, Sk) from position tensors."""
    dq = q_pos[..., :, None]
    dk = k_pos[..., None, :]
    ok = torch.ones(torch.broadcast_shapes(dq.shape, dk.shape),
                    dtype=torch.bool, device=dq.device)
    if causal:
        ok = ok & (dk <= dq)
    if window is not None:
        ok = ok & (dk > dq - window)
    return torch.where(ok, 0.0, NEG_INF).float()


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,Sq,Hq,hd)  k: (B,Sk,Hk,hd) -> (B,Hq,Sq,Sk)."""
    b, sq, hq, hd = q.shape
    hk = k.shape[2]
    q = q.reshape(b, sq, hk, hq // hk, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float())
    return s.reshape(b, hq, sq, k.shape[1])


def _gqa_out(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p: (B,Hq,Sq,Sk)  v: (B,Sk,Hk,hd) -> (B,Sq,Hq,hd)."""
    b, hq, sq, sk = p.shape
    hk = v.shape[2]
    p = p.reshape(b, hk, hq // hk, sq, sk)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.to(p.dtype))
    return o.reshape(b, sq, hq, v.shape[3])


# ---------------------------------------------------------------------------
# full-sequence attention (train / prefill)
# ---------------------------------------------------------------------------

def _attend_naive(q, k, v, bias, scale):
    s = _gqa_scores(q, k) * scale
    s = s + bias                                 # (Sq, Sk) broadcast
    p = torch.softmax(s.float(), dim=-1)
    return _gqa_out(p, v).to(q.dtype)


def multihead_attention(params: Params, cfg: ModelConfig, x: torch.Tensor,
                        positions: Optional[torch.Tensor] = None, *,
                        causal: bool = True, window: Optional[int] = None,
                        impl: str = "naive", kv_x=None, kv_positions=None,
                        use_rope: bool = True) -> torch.Tensor:
    """Full-sequence attention; ``kv_x`` given means cross-attention.

    x: (B, S, d); positions: (S,) integers (default 0..S-1).  Returns
    (B, S, d).  ``impl="kernel"`` needs self-attention over contiguous
    positions (train / prefill); with ``kv_x`` it takes the naive path,
    as the JAX package's ``"pallas"`` takes its chunked one."""
    if impl == "chunked":
        raise NotImplementedError(f"chunked attention {_LATER}")
    if impl not in ("naive", "kernel"):
        raise ValueError(f"unknown attention impl {impl!r}")
    b, s, d = x.shape
    hq, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    if positions is None:
        positions = torch.arange(s, device=x.device)
    src = x if kv_x is None else kv_x
    sk = src.shape[1]
    if kv_positions is None:
        kv_positions = (positions if kv_x is None
                        else torch.arange(sk, device=x.device))

    q = (x @ params["wq"]).reshape(b, s, hq, hd)
    k = (src @ params["wk"]).reshape(b, sk, hk, hd)
    v = (src @ params["wv"]).reshape(b, sk, hk, hd)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    # the JAX package's float32 1/sqrt(hd)
    scale = float(1.0 / torch.sqrt(torch.tensor(float(hd))))

    if impl == "naive" or kv_x is not None:
        bias = _causal_window_bias(positions, kv_positions, causal, window)
        out = _attend_naive(q, k, v, bias, scale)
    else:
        out = ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window, scale=scale).transpose(1, 2)
    return out.reshape(b, s, hq * hd) @ params["wo"]


def attention_decode(*args, **kwargs):
    """One-token decode against a KV cache: not ported yet."""
    raise NotImplementedError(f"KV-cache attention decode {_LATER}")


def init_kv_cache(*args, **kwargs):
    """The decode KV cache: not ported yet."""
    raise NotImplementedError(f"the KV cache {_LATER}")


def cross_attention_decode(*args, **kwargs):
    """Decode-time cross attention: not ported yet."""
    raise NotImplementedError(f"cross-attention decode {_LATER}")
