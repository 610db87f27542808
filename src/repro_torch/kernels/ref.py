"""Plain PyTorch versions of the kernels (the correctness contract).

Each function is the mathematical definition its CUDA kernel in
``csrc/`` must reproduce, as the JAX package's ``kernels/ref.py`` defines
it, and each repeats its kernel's arithmetic: every sum runs over its
reduced index in order, one rounded product and one rounded add per
term.  A kernel and its plain version therefore agree bit for bit on the
card (all but the bf16 flash attention, whose tensor-core sums run in
the hardware's order: see ``flash_attention_ref``), and a run with
``use_kernel=False`` picks the same medoids as one through the kernels —
k-medoids turns the last bit of a distance sum into a different, equally
good coreset.  The loops make these versions slow; they are no yardstick
of speed.  ``repro_torch.kernels.ops`` takes them for tensors on the
CPU, the tests hold them against the JAX ops, and ``chip_smoke.py``
holds the kernels against them on the card.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

BIG = 1e30      # padded-candidate mask (``repro_torch.core.kmedoids.BIG``)
NEG_INF = -1e30     # attention mask score, as in the JAX kernel
# keys per kv tile of the flash-attention kernels (``kKeys`` in
# ``csrc/flash_attention.cu``): the online softmax updates once per tile,
# so the plain version must tile the keys alike to give the kernel's bits
FLASH_BLOCK_K = 64
# the order in which ``csrc/rmsnorm.cu`` sums a row's squares: with V the
# elements of one 16-byte load (4 fp32, 8 bf16), a row of up to
# RMSNORM_WARP_CHUNKS chunks of 32 V has one warp of 32 lanes, a longer
# one RMSNORM_BLOCK_WARPS warps; lane l sums the squares of elements
# c*NV + V*l ... c*NV + V*l + V - 1 of every chunk c of N V (N its row's
# lanes) in order, each warp's lane sums meet in a butterfly, and the
# warps' sums are added in warp order; the plain version sums alike
RMSNORM_LANES = 32
RMSNORM_LOAD_BYTES = 16
RMSNORM_WARP_CHUNKS = 8
RMSNORM_BLOCK_WARPS = 8


def pairwise_l2_ref(x: torch.Tensor, y: Optional[torch.Tensor] = None, *,
                    squared: bool = False) -> torch.Tensor:
    """(m, d), (n, d) -> (m, n) Euclidean distances, fp32 accumulation:
    (‖a‖² + ‖b‖²) − 2·ab, the cross term summed over d in order."""
    y = x if y is None else y
    xf = x.float()
    yf = y.float()
    cross = torch.zeros((xf.shape[0], yf.shape[0]), dtype=torch.float32,
                        device=xf.device)
    for k in range(xf.shape[1]):
        cross += xf[:, k, None] * yf[None, :, k]
    sq = (torch.sum(xf * xf, dim=-1)[:, None]
          + torch.sum(yf * yf, dim=-1)[None, :]) - 2.0 * cross
    sq = torch.clamp_min(sq, 0.0)
    return sq if squared else torch.sqrt(sq)


def pairwise_l2_batched_ref(x: torch.Tensor, *,
                            squared: bool = False) -> torch.Tensor:
    """(C, M, D) -> (C, M, M) per-client self-distance stacks: each
    client's ``pairwise_l2_ref(x[c])``, the cross term summed over d in
    order."""
    xf = x.float()
    cross = torch.zeros(xf.shape[:-1] + xf.shape[-2:-1], dtype=torch.float32,
                        device=xf.device)
    for k in range(xf.shape[-1]):
        cross += xf[..., :, k, None] * xf[..., None, :, k]
    sq = torch.sum(xf * xf, dim=-1)
    sq = torch.clamp_min((sq[..., :, None] + sq[..., None, :]) - 2.0 * cross,
                         0.0)
    return sq if squared else torch.sqrt(sq)


def kmedoids_build_cost_ref(D: torch.Tensor, d_near: torch.Tensor,
                            vf: torch.Tensor) -> torch.Tensor:
    """Greedy BUILD add-cost over a masked distance stack.

    D (..., M, M); d_near/vf (..., M).  Returns
    cost[..., j] = Σ_i min(d_near_i, D_ij)·vf_i (over i in order) — the
    cost of the point set after adding candidate j to the current medoids
    (``d_near`` is each point's distance to its nearest chosen medoid;
    +BIG for the first pick reduces it to the plain column sum).
    """
    cost = torch.zeros(D.shape[:-2] + D.shape[-1:], dtype=torch.float32,
                       device=D.device)
    for i in range(D.shape[-2]):
        cost += (torch.minimum(d_near[..., i, None], D[..., i, :])
                 * vf[..., i, None])
    return cost


def kmedoids_delta_sweep_ref(D: torch.Tensor, d1: torch.Tensor,
                             d2: torch.Tensor, vf: torch.Tensor,
                             n_onehot: torch.Tensor):
    """FasterPAM swap-sweep reductions (the Δ(j, l) = A_j + B_{j,l} split).

    D (..., M, M); d1/d2/vf (..., M); n_onehot (..., M, K) one-hot of each
    point's nearest-medoid slot.  Returns (A (..., M), B (..., M, K)),
    both summed over i in order:

        A[j]    = Σ_i (min(D_ij, d1_i) − d1_i) · vf_i
        B[j, l] = Σ_i (clip(D_ij, d1_i, d2_i) − d1_i) · vf_i · onehot[i, l]

    ``clip(D, d1, d2) − d1`` is the case-collapsed form of the textbook
    ``min(D, d2) − d1 − min(D − d1, 0)`` (bitwise equal for d1 ≤ d2).
    """
    A = torch.zeros(D.shape[:-2] + D.shape[-1:], dtype=torch.float32,
                    device=D.device)
    B = torch.zeros(D.shape[:-2] + D.shape[-1:] + n_onehot.shape[-1:],
                    dtype=torch.float32, device=D.device)
    for i in range(D.shape[-2]):
        Di = D[..., i, :]
        lo, hi, w = d1[..., i, None], d2[..., i, None], vf[..., i, None]
        A += (torch.minimum(Di, lo) - lo) * w
        contrib = (torch.clamp(Di, lo, hi) - lo) * w
        B += contrib[..., :, None] * n_onehot[..., i, None, :]
    return A, B


# ---------------------------------------------------------------------------
# distance-free versions: these DO materialize D, as the JAX package's
# oracles do; the CUDA kernels rebuild each distance tile from the
# features in the same arithmetic, so the two agree bit for bit
# ---------------------------------------------------------------------------

def _pairwise_from_feats(x: torch.Tensor) -> torch.Tensor:
    """(..., M, F) -> (..., M, M) Euclidean stack with an exact-zero
    diagonal."""
    d = pairwise_l2_batched_ref(x)
    eye = torch.eye(x.shape[-2], dtype=torch.bool, device=x.device)
    return torch.where(eye, 0.0, d)


def kmedoids_build_cost_from_feats_ref(x: torch.Tensor, d_near: torch.Tensor,
                                       vf: torch.Tensor) -> torch.Tensor:
    """BUILD add-cost straight from the features: x (..., M, F),
    d_near/vf (..., M) -> (..., M).  ``kmedoids_build_cost_ref`` on the
    rebuilt distance stack, with padded candidate columns (vf_j = 0) at
    +BIG so a zero-padded feature row can never win the greedy argmin."""
    cost = kmedoids_build_cost_ref(_pairwise_from_feats(x), d_near, vf)
    return torch.where(vf > 0.0, cost, BIG)


def kmedoids_delta_sweep_from_feats_ref(x: torch.Tensor, d1: torch.Tensor,
                                        d2: torch.Tensor, vf: torch.Tensor,
                                        n_onehot: torch.Tensor):
    """FasterPAM (A, B) straight from the features: x (..., M, F),
    d1/d2/vf (..., M), n_onehot (..., M, K).  ``kmedoids_delta_sweep_ref``
    on the rebuilt distance stack, with A = +BIG at padded candidates
    (vf_j = 0) so a zero-padded row can never win a swap."""
    A, B = kmedoids_delta_sweep_ref(_pairwise_from_feats(x), d1, d2, vf,
                                    n_onehot)
    return torch.where(vf > 0.0, A, BIG), B


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def attention_mask(s: int, causal: bool, window: Optional[int],
                   device=None) -> torch.Tensor:
    """(S, S) bool: may query q see key k?  Causal: k <= q; window:
    k > q - window."""
    qp = torch.arange(s, device=device)[:, None]
    kp = torch.arange(s, device=device)[None, :]
    ok = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & (kp > qp - window)
    return ok


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, S, hd); k/v (B, Hk, S, hd) -> (B, Hq, S, hd) in q's dtype.

    Causal (or full) attention with an optional sliding window, GQA by
    kv head = q head // (Hq / Hk), computed in float32 as the kernel
    computes it: an online softmax over kv tiles of ``FLASH_BLOCK_K``
    keys with running (m, l, acc); each score a sum over hd in order,
    times ``scale``; masked scores at -1e30; per tile
    m' = max(m, max_j s_j), p_j = exp(s_j − m'), corr = exp(m − m'),
    l' = l·corr + p_0 + p_1 + …, acc' = acc·corr + p_0·v_0 + p_1·v_1 + …
    (left to right); one division acc / max(l, 1e-30) at the end.  The
    kernel skips the tiles that no query of its block can see; here every
    tile runs for every query, which changes no bit: a tile a query cannot
    see adds exact zeros once the query has seen a key, and what it adds
    before that is wiped by corr = 0 at the query's first visible key
    (its own position, always visible).

    For bf16 inputs the kernel is the tensor-core path, which rounds each
    tile's p_j to bf16 before the weighted sum of V (the register operand
    of its wgmma); so does this version: acc' = acc·corr + Σ bf16(p_j)·v_j,
    while l sums the fp32 p_j.  The two then differ only in the order of
    the fp32 sums inside a wgmma, which no plain version can repeat."""
    b, hq, s, hd = q.shape
    hk = k.shape[1]
    scale = float(scale if scale is not None else 1.0 / (hd ** 0.5))
    heads = torch.arange(hq, device=q.device) // (hq // hk)
    qf = q.float()
    kf = k.float()[:, heads]
    vf = v.float()[:, heads]
    ok = attention_mask(s, causal, window, q.device)
    m = torch.full((b, hq, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hq, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hq, s, hd), dtype=torch.float32, device=q.device)
    for k0 in range(0, s, FLASH_BLOCK_K):
        n = min(FLASH_BLOCK_K, s - k0)
        kt, vt = kf[:, :, k0:k0 + n], vf[:, :, k0:k0 + n]
        sc = torch.zeros((b, hq, s, n), dtype=torch.float32, device=q.device)
        for d in range(hd):
            sc = sc + qf[..., :, d, None] * kt[..., None, :, d]
        sc = torch.where(ok[:, k0:k0 + n], sc * scale, NEG_INF)
        m_new = torch.maximum(m, torch.amax(sc, dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        pv = (p.to(torch.bfloat16).float() if q.dtype == torch.bfloat16
              else p)
        l = l * corr
        acc = acc * corr[..., None]
        for j in range(n):
            l = l + p[..., j]
            acc = acc + pv[..., j, None] * vt[..., j, None, :]
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)


def flash_attention_f64(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """The float64 oracle of ``flash_attention_ref``: masked softmax
    attention in float64 from the same inputs, (B, Hq, S, hd) float64,
    a few heads at a time (a head's scores held whole).  It has no tiles
    and no rounding of P: the yardstick that the bf16 kernel and SDPA are
    both measured against."""
    b, hq, s, hd = q.shape
    g = hq // k.shape[1]
    scale = float(scale if scale is not None else 1.0 / (hd ** 0.5))
    ok = attention_mask(s, causal, window, q.device)
    qf = q.double().reshape(b * hq, s, hd)
    heads = torch.arange(b * hq, device=q.device)
    kv = (heads // hq) * k.shape[1] + (heads % hq) // g
    kf = k.double().reshape(-1, s, hd)
    vf = v.double().reshape(-1, s, hd)
    out = torch.empty_like(qf)
    step = max(1, (1 << 26) // (s * s))
    for h0 in range(0, b * hq, step):
        h = slice(h0, h0 + step)
        sc = torch.matmul(qf[h], kf[kv[h]].transpose(-1, -2)) * scale
        sc = sc.masked_fill(~ok, float("-inf"))
        out[h] = torch.matmul(torch.softmax(sc, dim=-1), vf[kv[h]])
    return out.reshape(b, hq, s, hd)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def rmsnorm_constants(d: int, eps: float):
    """(1/d, eps) rounded to float32 once, as Python floats: the kernel
    gets the same two values as ``c_float`` arguments."""
    return (float(np.float32(1.0) / np.float32(d)), float(np.float32(eps)))


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """x (G, m, d) fp32 or bf16, scale (G, d) -> (G, m, d) in x's dtype.

    Row r of group g: y = (x·rs)·scale[g] with rs = 1 / sqrt(Σx²·(1/d) +
    eps), all in float32, computed as the kernel computes it: with V the
    elements of one 16-byte load (4 fp32, 8 bf16), a row has W = 1 warp
    of ``RMSNORM_LANES`` lanes, or W = ``RMSNORM_BLOCK_WARPS`` when it is
    longer than ``RMSNORM_WARP_CHUNKS`` chunks of 32·V; lane l of its N =
    32·W lanes sums the squares of elements c·NV + V·l + e of every chunk
    c, chunk by chunk and e = 0 … V−1 within one, in order (a missing tail
    element adds nothing); each warp's 32 lane sums meet pairwise (lane l
    + lane l + 16, then + 8, 4, 2, 1); the W warp sums are added in warp
    order; each product and sum rounded on its own; the square root and
    the reciprocal correctly rounded (``torch.sqrt``, ``torch.reciprocal``;
    ``torch.rsqrt`` on the card is approximate); the output rounded to x's
    dtype to nearest even.  The order depends on d and V alone: a short
    row's kernel lanes are the first lanes of this order, whose others
    add zeros."""
    d = x.shape[-1]
    inv_d, eps32 = rmsnorm_constants(d, eps)
    xf = x.float()
    sq = xf * xf
    vec = RMSNORM_LOAD_BYTES // x.element_size()
    warps = (1 if d <= RMSNORM_WARP_CHUNKS * RMSNORM_LANES * vec
             else RMSNORM_BLOCK_WARPS)
    lanes = RMSNORM_LANES * warps
    chunk = lanes * vec
    n = -(-d // chunk)
    if n * chunk != d:
        sq = F.pad(sq, (0, n * chunk - d))
    sq = sq.reshape(sq.shape[:-1] + (n, lanes, vec))
    acc = sq[..., 0, :, 0]
    for j in range(1, n * vec):
        acc = acc + sq[..., j // vec, :, j % vec]
    acc = acc.reshape(acc.shape[:-1] + (warps, RMSNORM_LANES))
    w = RMSNORM_LANES
    while w > 1:
        w //= 2
        acc = acc[..., :w] + acc[..., w:2 * w]
    total = acc[..., 0, 0]
    for i in range(1, warps):
        total = total + acc[..., i, 0]
    rs = torch.reciprocal(torch.sqrt(total[..., None] * inv_d + eps32))
    return ((xf * rs) * scale.float()[..., None, :]).to(x.dtype)
