"""Building blocks shared by the port's models, as the JAX package's
``models/layers.py`` defines them: initialisers, RMSNorm and LayerNorm,
rotary and sinusoidal position embeddings, the feed-forward block and
the stacked-layer helpers.

Parameters are plain dicts of tensors, as in the JAX package; dense
kernels are (d_in, d_out) and multiply as ``x @ W``.  Initialisers draw
from an explicit ``torch.Generator`` on the generator's device (a model
of billions of parameters is drawn on the card, not moved there); they
do not replay the JAX package's keys.  RMSNorm goes
through ``repro_torch.kernels.ops.rmsnorm``: the CUDA kernel on the card,
its plain version on the CPU.  (The JAX package's model norms are plain
jnp; its fused Pallas RMSNorm is reached only by its kernel test.)
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               scale: float | None = None) -> torch.Tensor:
    """(d_in, d_out) float32 N(0, 1)·scale, scale = 1/sqrt(d_in) by
    default — the JAX package's ``dense_init`` with a torch generator."""
    scale = scale if scale is not None else 1.0 / np.sqrt(d_in)
    return torch.randn((d_in, d_out), generator=generator,
                       dtype=torch.float32, device=generator.device) * scale


def embed_init(generator: torch.Generator, vocab: int, d: int
               ) -> torch.Tensor:
    """(vocab, d) float32 N(0, 1)·0.02."""
    return torch.randn((vocab, d), generator=generator, dtype=torch.float32,
                       device=generator.device) * 0.02


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-5,
            use_kernel: Optional[bool] = None) -> torch.Tensor:
    """x·rsqrt(mean(x²) + eps)·scale, in float32, back in x's dtype.

    A launch site of kernel 8 (``csrc/rmsnorm.cu``, the port of the TPU
    kernel ``src/repro/kernels/rmsnorm.py::rmsnorm_pallas``), bound by
    the bytes of x read once and y written once: ``use_kernel`` is the
    tri-state of ``ops.rmsnorm`` (None = the kernel on the card, the plain
    version on the CPU), and under ``vmap`` each client's scale stays its
    own in one launch."""
    return ops.rmsnorm(x, params["scale"], eps=eps, use_kernel=use_kernel)


def init_layernorm(d: int, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm(params: Params, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """(x − mean)·rsqrt(var + eps)·scale + bias over the last axis, in
    float32, back in x's dtype (the population variance, as ``jnp.var``).
    Plain PyTorch: no TPU kernel stands behind it."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    # theta filled on the device: a host tensor copied there would wait
    # for the card's queue to drain at every call
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                      device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, d_head); positions: (..., S) integers.  Rotates the
    two halves of each head, as the JAX package does."""
    d_head = x.shape[-1]
    freqs = rope_freqs(d_head, theta, x.device)              # (d_head/2,)
    angles = positions[..., None].float() * freqs            # (..., S, d/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, d/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(seq: int, d: int, device=None) -> torch.Tensor:
    """(seq, d) float32: sin at the even columns, cos at the odd, the
    angles in float64 numpy as the JAX package computes them."""
    pos = np.arange(seq)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    out = np.zeros((seq, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return torch.from_numpy(out).to(device)


# ---------------------------------------------------------------------------
# MLP / SwiGLU
# ---------------------------------------------------------------------------

def init_mlp(generator: torch.Generator, cfg: ModelConfig,
             d_ff: int | None = None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "silu":
        return {"w_gate": dense_init(generator, d, f),
                "w_up": dense_init(generator, d, f),
                "w_down": dense_init(generator, f, d)}
    return {"w_up": dense_init(generator, d, f),
            "w_down": dense_init(generator, f, d)}


def mlp(params: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """SwiGLU (``act="silu"``) or a plain GELU MLP; GELU is the tanh
    approximation, ``jax.nn.gelu``'s default."""
    if act == "silu":
        g = F.silu(x @ params["w_gate"])
        u = x @ params["w_up"]
        return (g * u) @ params["w_down"]
    h = F.gelu(x @ params["w_up"], approximate="tanh")
    return h @ params["w_down"]


# ---------------------------------------------------------------------------
# stacked-layer helpers
# ---------------------------------------------------------------------------

def init_stacked(generator: torch.Generator, n_layers: int,
                 init_one: Callable[[torch.Generator], Params]) -> Params:
    """``n_layers`` copies of a module, stacked on a leading axis: layer
    i is ``init_one(generator)``, drawn in turn from the one generator.
    Each layer is copied into the preallocated stack as it is drawn, so
    the peak is the stack and one layer."""
    first = init_one(generator)
    out = {k: torch.empty((n_layers,) + v.shape, dtype=v.dtype,
                          device=v.device) for k, v in first.items()}
    for k, v in first.items():
        out[k][0] = v
    del first
    for i in range(1, n_layers):
        for k, v in init_one(generator).items():
            out[k][i] = v
    return out


def subparams(params: Params, name: str) -> Params:
    """The leaves under ``name`` of a flat dict of dotted tree paths,
    keyed by the rest of their path (``subparams(p, "ln1")["scale"]``)."""
    pre = name + "."
    return {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}


def unembed(params: Params, h: torch.Tensor) -> torch.Tensor:
    """h: (..., d) -> logits (..., vocab)."""
    return h @ params["w_unembed"]
