"""The JAX package's ``models/xlstm.py`` (Beck et al., arXiv:2405.04517):
the sLSTM and mLSTM cells, both with exponential gating and a
log-domain stabiliser state m.

Training and prefill run each recurrence as a Python loop over time (the
JAX package's ``lax.scan``); decode applies the same cell to one step.
Parameters are a nested dict as in the JAX package; the blocks' RMSNorms
go through ``repro_torch.kernels.ops.rmsnorm`` (kernel 8 on the card).
The mLSTM block is the fleet's ``xlstm`` workload; both blocks make up
``Model`` for ``family="xlstm"`` (xlstm-125m's ``msmsmsmsmsms``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, init_rmsnorm, rmsnorm


class MLSTMState(NamedTuple):
    C: torch.Tensor  # (B, H, hd, hd)
    n: torch.Tensor  # (B, H, hd)
    m: torch.Tensor  # (B, H)


class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, H, hd)
    n: torch.Tensor  # (B, H, hd)
    h: torch.Tensor  # (B, H, hd)
    m: torch.Tensor  # (B, H, hd)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(generator: torch.Generator, cfg: ModelConfig):
    d, h = cfg.d_model, cfg.n_heads
    dev = generator.device
    return {
        "norm": init_rmsnorm(d, dev),
        "wq": dense_init(generator, d, d),
        "wk": dense_init(generator, d, d),
        "wv": dense_init(generator, d, d),
        "wi": dense_init(generator, d, h, scale=0.02),
        "wf": dense_init(generator, d, h, scale=0.02),
        # forget-bias init keeps early memory
        "bf": torch.full((h,), 3.0, device=dev),
        "bi": torch.zeros((h,), device=dev),
        "wo_gate": dense_init(generator, d, d),
        "w_out": dense_init(generator, d, d),
    }


def mlstm_block(params, cfg: ModelConfig, x: torch.Tensor,
                state: Optional[MLSTMState] = None, *, decode: bool = False,
                use_kernel: Optional[bool] = None):
    """x: (B, S, d) -> (B, S, d), new state.  ``decode`` continues
    ``state`` by one step (x holds it).  ``use_kernel`` is the norm's
    tri-state (``ops.rmsnorm``).

    The cell of the JAX package's ``_mlstm_cell``, per time step t:
    a_t = log σ(f_t) + m_{t−1}, m_t = max(a_t, i_t), f = exp(a_t − m_t),
    i = exp(i_t − m_t), C_t = f·C_{t−1} + i·v_t k_tᵀ, n_t = f·n_{t−1} +
    i·k_t, and h_t = C_t q_t / max(|n_t·q_t|, exp(−m_t)), each value by
    the same operations as there.  Only the two recurrences are loops:
    the stabiliser m, and the memory C with n as one more row, whose step
    is one multiply and one add; the gates, the updates i·v_t k_tᵀ and
    h_t run once over all steps.  A step of the fleet's vmapped SGD so
    makes under half the tensor calls of a loop over the whole cell, each
    of which costs host time on the card (PERF.md)."""
    b, s, d = x.shape
    h, hd = cfg.n_heads, d // cfg.n_heads
    if decode and s != 1:
        raise ValueError(f"mlstm_block: decode takes one step, got S={s}")
    xn = rmsnorm(params["norm"], x, cfg.norm_eps, use_kernel=use_kernel)
    q = (xn @ params["wq"]).reshape(b, s, h, hd) / math.sqrt(hd)
    k = (xn @ params["wk"]).reshape(b, s, h, hd) / math.sqrt(hd)
    v = (xn @ params["wv"]).reshape(b, s, h, hd)
    i_pre = xn @ params["wi"] + params["bi"]
    f_pre = xn @ params["wf"] + params["bf"]
    if state is None:
        state = init_mlstm_state(cfg, b, x.dtype, x.device)

    m = state.m
    a_s, m_s = [], []
    for lf, i_t in zip(F.logsigmoid(f_pre).unbind(1), i_pre.unbind(1)):
        a = lf + m
        m = torch.maximum(a, i_t)
        a_s.append(a)
        m_s.append(m)
    a_s, m_s = torch.stack(a_s, dim=1), torch.stack(m_s, dim=1)  # (B, S, H)
    f_act = torch.exp(a_s - m_s)[..., None, None]
    i_act = torch.exp(i_pre - m_s)[..., None, None]
    # rows 0..hd-1: C; row hd: n
    upd = i_act * torch.cat([v[..., :, None] * k[..., None, :],
                             k[..., None, :]], dim=-2)  # (B, S, H, hd+1, hd)
    cn = torch.cat([state.C, state.n[..., None, :]], dim=-2)
    cns = []
    for f_t, u_t in zip(f_act.unbind(1), upd.unbind(1)):
        cn = cn * f_t + u_t
        cns.append(cn)
    cns = torch.stack(cns, dim=1)
    denom = torch.maximum(torch.abs(torch.sum(cns[..., hd, :] * q, dim=-1)),
                          torch.exp(-m_s))
    hs = (torch.matmul(cns[..., :hd, :], q[..., None])[..., 0]
          / denom[..., None])                               # (B, S, H, hd)
    o = torch.sigmoid(xn @ params["wo_gate"])
    out = (hs.reshape(b, s, d) * o) @ params["w_out"]
    return x + out, MLSTMState(cn[..., :hd, :], cn[..., hd, :], m)


def init_mlstm_state(cfg: ModelConfig, batch: int,
                     dtype: torch.dtype = torch.float32,
                     device=None) -> MLSTMState:
    h, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    return MLSTMState(
        C=torch.zeros((batch, h, hd, hd), dtype=dtype, device=device),
        n=torch.zeros((batch, h, hd), dtype=dtype, device=device),
        m=torch.full((batch, h), -1e30, dtype=dtype, device=device),
    )


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(generator: torch.Generator, cfg: ModelConfig):
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    dev = generator.device
    return {
        "norm": init_rmsnorm(d, dev),
        # input projections for gates z, i, f, o
        "w_in": dense_init(generator, d, 4 * d),
        # block-diagonal recurrent weights per head per gate
        "r": torch.randn((4, h, hd, hd), generator=generator,
                         device=dev) / math.sqrt(hd),
        "b": torch.cat([torch.zeros((2 * d,), device=dev),
                        torch.full((d,), 3.0, device=dev),
                        torch.zeros((d,), device=dev)]),
        "w_out": dense_init(generator, d, d),
        "out_norm": init_rmsnorm(d, dev),
    }


def slstm_block(params, cfg: ModelConfig, x: torch.Tensor,
                state: Optional[SLSTMState] = None, *, decode: bool = False,
                use_kernel: Optional[bool] = None):
    """x: (B, S, d) -> (x + out, new state).  ``decode`` continues
    ``state`` by one step (x holds it).  ``use_kernel`` is the two norms'
    tri-state (``ops.rmsnorm``).

    The cell of the JAX package's ``_slstm_cell``, per time step t, from
    the gates' pre-activations g_t = (xn W_in + b)_t + R h_{t−1} (R
    block-diagonal: a (hd, hd) matrix a gate and head): z = tanh(g_z),
    o = σ(g_o), a_t = log σ(g_f) + m_{t−1}, m_t = max(a_t, g_i),
    f = exp(a_t − m_t), i = exp(g_i − m_t), c_t = f·c_{t−1} + i·z,
    n_t = f·n_{t−1} + i and h_t = o·c_t / max(n_t, 1e−6), each value by
    the same operations as there.  The input projection runs once over
    all steps; the cell is a loop over S, its state laid out (H, B, hd)
    so that R h_{t−1} is one batched product over the heads.  Then
    ``out_norm`` over the h_t, ``w_out`` and the residual."""
    b, s, d = x.shape
    h, hd = cfg.n_heads, d // cfg.n_heads
    if decode and s != 1:
        raise ValueError(f"slstm_block: decode takes one step, got S={s}")
    xn = rmsnorm(params["norm"], x, cfg.norm_eps, use_kernel=use_kernel)
    gates = (xn @ params["w_in"] + params["b"]).reshape(b, s, 4, h, hd)
    gates = gates.permute(1, 3, 0, 2, 4)              # (S, H, B, 4, hd)
    if state is None:
        state = init_slstm_state(cfg, b, x.dtype, x.device)
    # rt[h, e, g·hd + d] = r[g, h, d, e]: R h for all four gates at once
    rt = params["r"].permute(1, 3, 0, 2).reshape(h, hd, 4 * hd)
    c, n, hp, m = (t.transpose(0, 1) for t in state)  # (H, B, hd)
    hs = []
    for g_t in gates.unbind(0):
        pre = g_t + torch.bmm(hp.to(rt.dtype), rt).view(h, b, 4, hd)
        z = torch.tanh(pre[:, :, 0])
        i_pre = pre[:, :, 1]
        o = torch.sigmoid(pre[:, :, 3])
        a = F.logsigmoid(pre[:, :, 2]) + m
        m = torch.maximum(a, i_pre)
        f_act = torch.exp(a - m)
        i_act = torch.exp(i_pre - m)
        c = f_act * c + i_act * z
        n = f_act * n + i_act
        hp = o * c / torch.clamp_min(n, 1e-6)
        hs.append(hp)
    hs = torch.stack(hs, dim=2).permute(1, 2, 0, 3)   # (B, S, H, hd)
    out = rmsnorm(params["out_norm"], hs.reshape(b, s, d), cfg.norm_eps,
                  use_kernel=use_kernel)
    return x + out @ params["w_out"], SLSTMState(
        *(t.transpose(0, 1) for t in (c, n, hp, m)))


def init_slstm_state(cfg: ModelConfig, batch: int,
                     dtype: torch.dtype = torch.float32,
                     device=None) -> SLSTMState:
    h, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    z = torch.zeros((batch, h, hd), dtype=dtype, device=device)
    return SLSTMState(c=z, n=z, h=z,
                      m=torch.full((batch, h, hd), -1e30, dtype=dtype,
                                   device=device))
