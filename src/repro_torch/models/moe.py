"""The Mixture-of-Experts FFN of the JAX package's ``models/moe.py``
(Llama-4-style: top-1 routed experts plus a shared expert).

Dispatch is the sort-based formulation: tokens are sorted by their
routed expert (a stable sort, as ``jnp.argsort``), gathered into an
(E, C, d) buffer of ``C`` rows an expert (the rows past ``C`` dropped),
run through the experts as three batched products (E, C, d)·(E, d, f)
and back, and scattered back weighted by the router probability.  A
dropped token falls through on the residual; the shared expert still
sees every token.

Parameters are a flat dict whose keys are the JAX tree paths below the
layer (``router``, ``w_gate``, ``w_up``, ``w_down``, ``shared.w_gate``,
...).  The expert products are plain ``torch.bmm``: the JAX package
computes them outside any Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, init_mlp, mlp, subparams

Params = Dict[str, torch.Tensor]


def init_moe(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """Router (d, E) at scale 0.02 and the E experts' SwiGLU matrices,
    drawn on the generator's device, plus the shared expert's MLP."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dev = generator.device

    def normal(shape, fan_in):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=dev) / math.sqrt(fan_in)

    params = {"router": dense_init(generator, d, e, scale=0.02),
              "w_gate": normal((e, d, f), d),
              "w_up": normal((e, d, f), d),
              "w_down": normal((e, f, d), f)}
    if cfg.use_shared_expert:
        params.update({f"shared.{k}": v
                       for k, v in init_mlp(generator, cfg).items()})
    return params


def _capacity(n_tokens: int, n_experts: int, factor: float) -> int:
    c = int(n_tokens * factor / n_experts)
    return max(8, min(n_tokens, c))


def _route(params: Params, xt: torch.Tensor):
    """(probs (N, E) fp32, expert (N,), gate (N,)): the softmax of the
    router logits, its first maximal index and its maximum."""
    probs = torch.softmax((xt @ params["router"]).float(), dim=-1)
    return probs, torch.argmax(probs, dim=-1), torch.amax(probs, dim=-1)


def _aux(probs: torch.Tensor, expert: torch.Tensor, e: int) -> torch.Tensor:
    """The Switch load-balance loss E·Σ density·mean(probs)."""
    density = torch.mean(F.one_hot(expert, e).float(), dim=0)
    return e * torch.sum(density * torch.mean(probs, dim=0))


def dispatch(expert: torch.Tensor, e: int, cap: int):
    """Sort-based dispatch of N routed tokens into E·cap slots.

    Returns (order, slot, keep): ``order`` the stable sort of the tokens
    by expert, ``slot`` (N,) each sorted token's row of the (E·cap + 1, d)
    buffer, and ``keep`` whether its rank within its expert is below
    ``cap``; a dropped token's slot is the scratch row E·cap."""
    order = torch.argsort(expert, stable=True)
    sorted_expert = expert[order]
    same = F.one_hot(sorted_expert, e)                       # (N, E)
    rank_all = torch.cumsum(same, dim=0) - 1
    rank = rank_all.gather(1, sorted_expert[:, None])[:, 0]
    keep = rank < cap
    slot = sorted_expert * cap + torch.clamp_max(rank, cap - 1)
    slot = torch.where(keep, slot, e * cap)
    return order, slot, keep


def moe_ffn(params: Params, cfg: ModelConfig, x: torch.Tensor):
    """x: (B, S, d) -> (B, S, d), aux_loss (scalar fp32).

    Top-1 routing with capacity dropping; dropped tokens fall through on
    the residual (and the shared expert still processes every token)."""
    b, s, d = x.shape
    e = cfg.n_experts
    n = b * s
    xt = x.reshape(n, d)
    probs, expert, gate = _route(params, xt)
    aux = _aux(probs, expert, e)

    # --- sort-based dispatch ---------------------------------------------
    cap = _capacity(n, e, cfg.moe_capacity_factor)
    order, slot, keep = dispatch(expert, e, cap)
    # dropped tokens all land on the scratch row, which nothing reads
    buf = x.new_zeros((e * cap + 1, d)).index_put((slot,), xt[order])
    hidden = buf[: e * cap].reshape(e, cap, d)

    # --- expert compute --------------------------------------------------
    g = F.silu(torch.bmm(hidden, params["w_gate"]))
    u = torch.bmm(hidden, params["w_up"])
    out = torch.bmm(g * u, params["w_down"])                 # (E, C, d)

    # --- un-dispatch -----------------------------------------------------
    flat = torch.cat([out.reshape(e * cap, d), out.new_zeros((1, d))])
    routed_sorted = flat[slot] * keep[:, None]               # sorted order
    inv = torch.argsort(order)
    routed = routed_sorted[inv] * gate[:, None].to(x.dtype)

    y = routed
    if cfg.use_shared_expert:
        y = y + mlp(subparams(params, "shared"), xt, cfg.act)
    return y.reshape(b, s, d), aux


def moe_ffn_dense_oracle(params: Params, cfg: ModelConfig, x: torch.Tensor):
    """Reference: every expert processes every token (no capacity drops).

    Used by tests to validate the sort-based dispatch on small shapes
    where capacity >= tokens-per-expert."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    probs, expert, gate = _route(params, xt)
    g = F.silu(torch.einsum("nd,edf->enf", xt, params["w_gate"]))
    u = torch.einsum("nd,edf->enf", xt, params["w_up"])
    out = torch.einsum("enf,efd->end", g * u, params["w_down"])
    sel = out.gather(0, expert[None, :, None].expand(1, -1, d))[0]
    y = sel * gate[:, None].to(x.dtype)
    if cfg.use_shared_expert:
        y = y + mlp(subparams(params, "shared"), xt, cfg.act)
    return y.reshape(b, s, d), _aux(probs, expert, cfg.n_experts)
