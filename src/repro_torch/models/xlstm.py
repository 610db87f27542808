"""The mLSTM half of the JAX package's ``models/xlstm.py`` (Beck et al.,
arXiv:2405.04517): the exponential-gated matrix-memory cell with a
log-domain stabiliser state m.

Training and prefill run the recurrence as a Python loop over time (the
JAX package's ``lax.scan``); decode applies the same cell to one step.
Parameters are a nested dict as in the JAX package; the block's RMSNorm
goes through ``repro_torch.kernels.ops.rmsnorm`` (kernel 8 on the card).
The sLSTM half (``init_slstm``, ``slstm_block``) is on no fleet path and
comes with the model zoo, ROADMAP item 16.
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


def init_mlstm(generator: torch.Generator, cfg: ModelConfig):
    d, h = cfg.d_model, cfg.n_heads
    return {
        "norm": init_rmsnorm(d),
        "wq": dense_init(generator, d, d),
        "wk": dense_init(generator, d, d),
        "wv": dense_init(generator, d, d),
        "wi": dense_init(generator, d, h, scale=0.02),
        "wf": dense_init(generator, d, h, scale=0.02),
        "bf": torch.full((h,), 3.0),  # forget-bias init keeps early memory
        "bi": torch.zeros((h,)),
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
