"""Grouped-query attention with RoPE, sliding windows and KV-cache
decode.

Three implementations share one math definition, as in the JAX
package's ``models/attention.py``:

  * ``naive``   — materializes the (S, S) score matrix;
  * ``chunked`` — flash-style online softmax over KV blocks of 1024 keys
                  inside Q blocks of 512 queries, in plain PyTorch;
  * ``kernel``  — ``repro_torch.kernels.ops.flash_attention``: the
                  hand-written CUDA flash-attention kernel on the card
                  (the JAX package's ``"pallas"``), its plain version on
                  the CPU or with ``use_kernel=False``.

``chunked`` takes a ragged last block as it is.  The JAX package pads
k/v to a multiple of its KV block and gives the padded keys a position
that every query may see, so above one block at a ragged S its queries
attend to zero keys; here no padded key exists, and the result is the
naive attention's.

One-token decode (``attention_decode``) reads a KV cache of the whole
sequence, or a ring of ``attention_window`` slots; it is plain PyTorch,
as the JAX package computes it in plain jnp; so is the audio decoder's
cross-attention decode (``cross_attention_decode``) over the encoder's
precomputed K/V.  Parameters are a dict of (d_in, d_out) matrices
``wq``, ``wk``, ``wv``, ``wo``; activations are (B, S, H, hd) between
the projections, as in the JAX package.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import apply_rope, dense_init

Params = Dict[str, torch.Tensor]


def init_attention(generator: torch.Generator, cfg: ModelConfig,
                   cross: bool = False) -> Params:
    """``wq``, ``wk``, ``wv``, ``wo``; a cross-attention (``cross``) has
    the same leaves, its k and v projecting the encoder's states."""
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


@functools.lru_cache(maxsize=None)
def _scale(hd: int) -> float:
    """The JAX package's float32 1/sqrt(hd), as a Python float."""
    return float(1.0 / torch.sqrt(torch.tensor(float(hd))))


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


def _expand_kv(kv: torch.Tensor, hq: int) -> torch.Tensor:
    """(B,S,Hk,hd) -> (B,Hq,S,hd) by repeating each kv head."""
    return torch.repeat_interleave(kv, hq // kv.shape[2],
                                   dim=2).transpose(1, 2)


def _attend_chunked(q, k, v, q_pos, k_pos, causal, window, scale,
                    q_block: int = 512, kv_block: int = 1024):
    """Flash-style two-level blocking with online softmax: for each block
    of ``q_block`` queries, a running (m, l, acc) over blocks of
    ``kv_block`` keys, in float32.  The last block of each is ragged, not
    padded (see the module docstring)."""
    b, sq, hq, hd = q.shape
    sk = k.shape[1]
    outs = []
    for q0 in range(0, sq, q_block):
        q_i, qp_i = q[:, q0:q0 + q_block], q_pos[q0:q0 + q_block]
        n = q_i.shape[1]
        m = torch.full((b, hq, n), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, hq, n), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, hq, n, hd), dtype=torch.float32,
                          device=q.device)
        for k0 in range(0, sk, kv_block):
            kp_j = k_pos[k0:k0 + kv_block]
            bias = _causal_window_bias(qp_i, kp_j, causal, window)
            s = _gqa_scores(q_i, k[:, k0:k0 + kv_block]) * scale + bias
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqs,bhsd->bhqd", p,
                _expand_kv(v[:, k0:k0 + kv_block], hq).float())
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.transpose(1, 2).to(q.dtype))   # (B,qb,Hq,hd)
    return torch.cat(outs, dim=1)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w under the JAX package's type promotion: bf16 activations
    (the audio encoder's input in a bf16 decode state) against fp32
    weights multiply in fp32."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


def multihead_attention(params: Params, cfg: ModelConfig, x: torch.Tensor,
                        positions: Optional[torch.Tensor] = None, *,
                        causal: bool = True, window: Optional[int] = None,
                        impl: str = "naive", kv_x=None, kv_positions=None,
                        use_rope: bool = True,
                        use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Full-sequence attention; ``kv_x`` given means cross-attention.

    x: (B, S, d); positions: (S,) integers (default 0..S-1).  Returns
    (B, S, d).  ``impl="kernel"`` needs self-attention over contiguous
    positions (train / prefill); with ``kv_x`` it takes the chunked path,
    as the JAX package's ``"pallas"`` does.  ``use_kernel`` is
    ``ops.flash_attention``'s tri-state for ``impl="kernel"``."""
    if impl not in ("naive", "chunked", "kernel"):
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

    q = _project(x, params["wq"]).reshape(b, s, hq, hd)
    k = _project(src, params["wk"]).reshape(b, sk, hk, hd)
    v = _project(src, params["wv"]).reshape(b, sk, hk, hd)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    scale = _scale(hd)

    if impl == "naive":
        bias = _causal_window_bias(positions, kv_positions, causal, window)
        out = _attend_naive(q, k, v, bias, scale)
    elif impl == "chunked" or kv_x is not None:
        out = _attend_chunked(q, k, v, positions, kv_positions, causal,
                              window, scale)
    else:
        out = ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window, scale=scale,
            use_kernel=use_kernel).transpose(1, 2)
    return out.reshape(b, s, hq * hd) @ params["wo"]


# ---------------------------------------------------------------------------
# KV-cache decode (one token)
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: ModelConfig, n_layers: int, batch: int, seq_len: int,
                  dtype=torch.bfloat16, device=None) -> Params:
    """Zero caches k, v (L, B, S_cache, Hk, hd): S_cache = seq_len, or a
    ring of min(seq_len, window) slots under a sliding window."""
    w = cfg.attention_window
    size = min(seq_len, w) if w else seq_len
    shape = (n_layers, batch, size, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_slot_positions(cache_size: int, pos: int, window: Optional[int],
                         device=None) -> torch.Tensor:
    """Position held by each ring-buffer slot at decode step ``pos``.

    Full cache (window None): slot i holds position i (valid if i <= pos).
    Ring cache: slot i holds the largest p <= pos with p % size == i.
    """
    idx = torch.arange(cache_size, device=device)
    if window is None:
        return idx
    return pos - torch.remainder(pos - idx, cache_size)


def attention_decode(params: Params, cfg: ModelConfig, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int,
                     *, window: Optional[int] = None, use_rope: bool = True):
    """One-token decode.

    x: (B, 1, d); cache_k/v: (B, S_cache, Hk, hd); pos: the position of
    the *new* token (an int).  Writes the token's k and v into their
    slot of the caches in place and returns (out (B,1,d), cache_k,
    cache_v), the caches being the tensors it was given."""
    b = x.shape[0]
    hq, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s_cache = cache_k.shape[1]
    pos = int(pos)

    q = (x @ params["wq"]).reshape(b, 1, hq, hd)
    k = (x @ params["wk"]).reshape(b, 1, hk, hd)
    v = (x @ params["wv"]).reshape(b, 1, hk, hd)
    if use_rope:
        posv = torch.full((1,), pos, device=x.device)
        q = apply_rope(q, posv, cfg.rope_theta)
        k = apply_rope(k, posv, cfg.rope_theta)

    slot = pos % s_cache if window else min(pos, s_cache - 1)
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)

    slot_pos = cache_slot_positions(s_cache, pos, window, x.device)
    valid = (slot_pos <= pos) & (slot_pos >= 0)
    if window:
        valid = valid & (slot_pos > pos - window)
    bias = torch.where(valid, 0.0, NEG_INF).float()          # (S_cache,)

    scale = _scale(hd)
    s = _gqa_scores(q, cache_k.to(q.dtype)) * scale          # (B,Hq,1,Sc)
    p = torch.softmax((s + bias).float(), dim=-1)
    out = _gqa_out(p, cache_v).to(x.dtype)                   # (B,1,Hq,hd)
    return out.reshape(b, 1, hq * hd) @ params["wo"], cache_k, cache_v


def cross_attention_decode(params: Params, cfg: ModelConfig,
                           x: torch.Tensor, enc_k: torch.Tensor,
                           enc_v: torch.Tensor) -> torch.Tensor:
    """Decode-time cross attention over precomputed encoder K/V.

    x: (B, 1, d); enc_k/enc_v: (B, S_enc, Hk, hd).  q from x, no RoPE,
    every encoder position visible, softmax in float32; returns (B, 1,
    d)."""
    b = x.shape[0]
    hq, hd = cfg.n_heads, cfg.d_head
    q = (x @ params["wq"]).reshape(b, 1, hq, hd)
    s = _gqa_scores(q, enc_k.to(q.dtype)) * _scale(hd)      # (B,Hq,1,Se)
    p = torch.softmax(s.float(), dim=-1)
    out = _gqa_out(p, enc_v).to(x.dtype)                     # (B,1,Hq,hd)
    return out.reshape(b, 1, hq * hd) @ params["wo"]
