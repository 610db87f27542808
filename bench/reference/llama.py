"""A dense decoder LM of the Llama kind (Yi-9B, arXiv:2403.04652):
pre-norm layers of RMSNorm, grouped-query causal attention with rotary
positions (the two halves of each head rotated), and a SwiGLU MLP; a
final RMSNorm and an untied output matrix.  float32 throughout, with the
(S, S) scores materialised, softmax in float32.  The weighted
next-token cross-entropy is the mean over a sequence's positions, then
the weighted mean over sequences.

Parameters are the flat dict the harness draws (``bench/inputs/
lm_init.py``): layer leaves stacked on a leading axis."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float
            ) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd): rotate the halves by position · θ^(−2i/hd)."""
    s, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / torch.pow(torch.full((), theta, device=x.device),
                          torch.arange(0, hd, 2, device=x.device) / hd)
    ang = torch.arange(s, device=x.device).float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    a, b = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], -1)


def attention(q, k, v):
    """Causal GQA: q (B, S, Hq, hd), k, v (B, S, Hk, hd)."""
    hq, hk, hd = q.shape[2], k.shape[2], q.shape[3]
    k = k.repeat_interleave(hq // hk, dim=2)
    v = v.repeat_interleave(hq // hk, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / hd ** 0.5
    n = q.shape[1]
    mask = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def forward(p: Params, cfg: Dict, tokens: torch.Tensor):
    """(logits (B, S, V), last hidden (B, S, d))."""
    hq, hk, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"]
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    x = p["embed"][tokens.long()]
    b, s, _ = x.shape
    for i in range(cfg["n_layers"]):
        def w(name):
            return p[f"layers.{name}"][i]
        h = rmsnorm(x, w("ln1.scale"), eps)
        q = rope((h @ w("attn.wq")).reshape(b, s, hq, hd), theta)
        k = rope((h @ w("attn.wk")).reshape(b, s, hk, hd), theta)
        v = (h @ w("attn.wv")).reshape(b, s, hk, hd)
        x = x + attention(q, k, v).reshape(b, s, hq * hd) @ w("attn.wo")
        h = rmsnorm(x, w("ln2.scale"), eps)
        x = x + (F.silu(h @ w("mlp.w_gate")) * (h @ w("mlp.w_up"))) \
            @ w("mlp.w_down")
    x = rmsnorm(x, p["ln_f.scale"], eps)
    return x @ p["w_unembed"], x


def loss(p: Params, cfg: Dict, tokens, labels, weights) -> torch.Tensor:
    logits, _ = forward(p, cfg, tokens)
    nll = -torch.gather(F.log_softmax(logits, -1), -1,
                        labels.long()[..., None])[..., 0]
    per_seq = nll.mean(-1)
    return torch.sum(per_seq * weights) / torch.clamp_min(weights.sum(),
                                                           1e-9)


def grad_features(p: Params, cfg: Dict, tokens, labels) -> torch.Tensor:
    """FedCore §4.3 at LM granularity: the last-layer gradient
    (softmax(z) − onehot(y)) W_outᵀ of each position, mean over a
    sequence's positions: (B, d)."""
    logits, _ = forward(p, cfg, tokens)
    dz = torch.softmax(logits, -1)
    dz.scatter_add_(-1, labels.long()[..., None],
                    -torch.ones_like(labels, dtype=dz.dtype)[..., None])
    return (dz @ p["w_unembed"].T).mean(1)


def sgd_step(p: Params, cfg: Dict, tokens, labels, weights, lr: float):
    """One plain SGD step; returns (new params, the step's loss)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    value = loss(leaves, cfg, tokens, labels, weights)
    grads = torch.autograd.grad(value, list(leaves.values()))
    with torch.no_grad():
        new = {k: v - lr * g for (k, v), g in zip(p.items(), grads)}
    return new, float(value.detach())


def forward_flops_per_token(cfg: Dict, seq: int) -> float:
    """Multiply-adds ×2 of one token's forward pass at sequence length
    ``seq``: every matrix product (the embedding lookup is none), and the
    causal half of QKᵀ and PV."""
    d, f, v = cfg["d_model"], cfg["d_ff"], cfg["vocab_size"]
    hq, hk, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"]
    mats = d * hq * hd + 2 * d * hk * hd + hq * hd * d + 3 * d * f
    attn = 2 * hq * hd * (seq + 1) / 2
    return 2.0 * (cfg["n_layers"] * (mats + attn) + d * v)
