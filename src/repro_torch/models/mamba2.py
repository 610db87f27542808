"""The Mamba2 (SSD) block of the JAX package's ``models/mamba2.py``:
the chunked-parallel scan for training and prefill, the single-token
recurrence of O(1) state for decode.

The SSD "minimal" formulation (Dao & Gu 2024): a scalar decay A a head,
a step dt a token, and B / C projections of state size N shared by the
heads (ngroups = 1):

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T        h: (heads, headdim, N)
    y_t = C_t . h_t + D x_t

The chunked algorithm computes the contributions inside a chunk with a
quadratic einsum and carries the chunks' end states with a short loop.
All of it is plain PyTorch, as the JAX package computes it in plain jnp;
the block's two RMSNorms go through ``ops.rmsnorm`` (kernel 8 on the
card) and the depthwise causal conv is ``F.conv1d`` with one group a
channel (the JAX package's ``lax.conv_general_dilated``).  Parameters
are a flat dict of the JAX tree paths (``norm_in.scale``, ``w_in``,
``conv_w`` (K, C), ...), so ``convert.params_from_jax`` changes no leaf.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (dense_init, init_rmsnorm, rmsnorm,
                                       subparams)


class MambaState(NamedTuple):
    ssm: torch.Tensor   # (B, nh, hd, N)
    conv: torch.Tensor  # (B, k-1, conv_channels)


def init_mamba2(generator: torch.Generator, cfg: ModelConfig):
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = cfg.ssm_heads
    conv_ch = di + 2 * n
    dev = generator.device
    dt = torch.exp(torch.rand((nh,), generator=generator, device=dev)
                   * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return {
        "norm_in.scale": init_rmsnorm(d, dev)["scale"],
        "w_in": dense_init(generator, d, 2 * di + 2 * n + nh),
        "conv_w": torch.randn((cfg.ssm_conv, conv_ch), generator=generator,
                              device=dev) * 0.1,
        "conv_b": torch.zeros((conv_ch,), device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device=dev)),
        "D": torch.ones((nh,), device=dev),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),  # inverse softplus
        "norm.scale": init_rmsnorm(di, dev)["scale"],
        "w_out": dense_init(generator, di, d),
    }


# ---------------------------------------------------------------------------
# chunked SSD scan
# ---------------------------------------------------------------------------

def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., L) -> (..., L, L) with out[t, s] = sum_{s < t' <= t} a[t'],
    -inf above the diagonal (masked before any ``exp``, so neither the
    value nor the gradient meets an overflow there)."""
    cs = torch.cumsum(a, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    L = a.shape[-1]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=a.device))
    return torch.where(mask, d, -math.inf)


def ssd_chunked(x, a, B, C, chunk: int, h0=None):
    """Chunk-parallel SSD.

    x: (b, s, nh, hd)   token inputs (already multiplied by dt)
    a: (b, s, nh)       log-decay per step (dt * A, negative)
    B, C: (b, s, n)     shared across heads (ngroups = 1)
    h0: (b, nh, hd, n)  initial state (decode continuation) or None.
    Returns y: (b, s, nh, hd), h_final: (b, nh, hd, n).
    """
    b, s, nh, hd = x.shape
    n = B.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = x.shape[1] // chunk
    xc = x.reshape(b, nc, chunk, nh, hd)
    Bc = B.reshape(b, nc, chunk, n)
    Cc = C.reshape(b, nc, chunk, n)
    ac = a.reshape(b, nc, chunk, nh).permute(0, 3, 1, 2)     # (b,nh,nc,l)

    a_cs = torch.cumsum(ac, dim=-1)                          # (b,nh,nc,l)
    L = torch.exp(_segsum(ac))                               # (b,nh,nc,l,l)

    # intra-chunk (quadratic)
    y_diag = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp", Cc, Bc, L, xc)

    # per-chunk end states
    decay_states = torch.exp(a_cs[..., -1:] - a_cs)          # (b,nh,nc,l)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, decay_states, xc)

    # inter-chunk recurrence: prev[c] is the state entering chunk c
    chunk_decay = torch.exp(a_cs[..., -1])                   # (b,nh,nc)
    h = torch.zeros((b, nh, hd, n), dtype=x.dtype, device=x.device) \
        if h0 is None else h0
    prev = []
    for c in range(nc):
        prev.append(h)
        h = h * chunk_decay[:, :, c, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                   # (b,nc,nh,hd,n)

    # inter-chunk contribution
    out_decay = torch.exp(a_cs)                              # (b,nh,nc,l)
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, prev_states,
                         out_decay)

    y = (y_diag + y_off).reshape(b, nc * chunk, nh, hd)
    return y[:, :s], h


def ssd_sequential(x, a, B, C, h0=None):
    """Step-by-step oracle for tests; same signature as ssd_chunked."""
    b, s, nh, hd = x.shape
    n = B.shape[-1]
    h = torch.zeros((b, nh, hd, n), dtype=x.dtype, device=x.device) \
        if h0 is None else h0
    ys = []
    for t in range(s):
        h = h * torch.exp(a[:, t])[..., None, None] + torch.einsum(
            "bhp,bn->bhpn", x[:, t], B[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", h, C[:, t]))
    return torch.stack(ys, dim=1), h


# ---------------------------------------------------------------------------
# causal depthwise conv
# ---------------------------------------------------------------------------

def causal_conv(x, w, b):
    """x: (B, S, C), w: (K, C) depthwise causal conv."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = F.conv1d(xp.transpose(1, 2), w.T[:, None, :],
                   groups=x.shape[-1])                       # (B, C, S)
    return out.transpose(1, 2) + b                           # (B, S, C)


def causal_conv_step(state, x_t, w, b):
    """state: (B, K-1, C) previous inputs; x_t: (B, 1, C)."""
    window = torch.cat([state, x_t], dim=1)                  # (B, K, C)
    y = torch.einsum("bkc,kc->bc", window, w) + b
    return window[:, 1:], y[:, None, :]


# ---------------------------------------------------------------------------
# full block
# ---------------------------------------------------------------------------

def _split_proj(cfg: ModelConfig, proj):
    di, n = cfg.d_inner, cfg.ssm_state
    z = proj[..., :di]
    xbc = proj[..., di:di + di + 2 * n]
    dt = proj[..., di + di + 2 * n:]
    return z, xbc, dt


def mamba2_block(params, cfg: ModelConfig, u: torch.Tensor,
                 state: Optional[MambaState] = None, *, decode: bool = False,
                 use_kernel: Optional[bool] = None):
    """u: (B, S, d_model) -> (B, S, d_model), new_state.

    decode=True requires S == 1 and a state; ``use_kernel`` is the two
    norms' tri-state (``ops.rmsnorm``).  The new state is new tensors,
    in the dtype the arithmetic gives (float32 from a bf16 state, as in
    the JAX package), never the given state written in place."""
    b, s, d = u.shape
    di, n, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    u = rmsnorm(subparams(params, "norm_in"), u, cfg.norm_eps,
                use_kernel=use_kernel)
    proj = u @ params["w_in"]
    z, xbc, dt = _split_proj(cfg, proj)

    if decode:
        conv_state, y_conv = causal_conv_step(state.conv, xbc,
                                              params["conv_w"],
                                              params["conv_b"])
    else:
        if state is not None:
            raise ValueError("prefill with prior state not supported")
        y_conv = causal_conv(xbc, params["conv_w"], params["conv_b"])

    y_conv = F.silu(y_conv)
    x_in = y_conv[..., :di].reshape(b, s, nh, hd)
    B_in = y_conv[..., di:di + n]
    C_in = y_conv[..., di + n:]

    A = -torch.exp(params["A_log"])                          # (nh,)
    # jax.nn.softplus is logaddexp(x, 0) everywhere (F.softplus turns to
    # the identity above its threshold)
    dtb = dt + params["dt_bias"]
    dt_s = torch.logaddexp(dtb, torch.zeros((), dtype=dtb.dtype,
                                            device=dtb.device))  # (b,s,nh)
    a = dt_s * A                                             # log decay
    x_dt = x_in * dt_s[..., None]

    if decode:
        h = state.ssm * torch.exp(a[:, 0])[..., None, None]
        h = h + torch.einsum("bhp,bn->bhpn", x_dt[:, 0], B_in[:, 0])
        y = torch.einsum("bhpn,bn->bhp", h, C_in[:, 0])[:, None]
        h_final = h
    else:
        y, h_final = ssd_chunked(x_dt, a, B_in, C_in, cfg.ssm_chunk)

    y = y + x_in * params["D"][None, None, :, None]
    y = y.reshape(b, s, di)
    y = rmsnorm(subparams(params, "norm"), y * F.silu(z), cfg.norm_eps,
                use_kernel=use_kernel)
    out = y @ params["w_out"]

    if decode:
        return out, MambaState(ssm=h_final, conv=conv_state)
    k = cfg.ssm_conv
    conv_tail = F.pad(xbc, (0, 0, max(0, k - 1 - s), 0))
    return out, MambaState(ssm=h_final, conv=conv_tail[:, -(k - 1):])


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> MambaState:
    return MambaState(
        ssm=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_headdim,
                         cfg.ssm_state), dtype=dtype, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv - 1,
                          cfg.d_inner + 2 * cfg.ssm_state), dtype=dtype,
                         device=device))
