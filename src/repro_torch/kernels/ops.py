"""Public wrappers around the kernels.

Each wrapper takes its plain PyTorch version (``kernels/ref.py``) for a
tensor that lies on the CPU, and launches its hand-written CUDA kernel
(``kernels/csrc/``) for a tensor on the card, or raises: there is no
fall back from the card to the plain version.  ``use_kernel`` is the
tri-state switch of the JAX package's ops, resolved by the tensor's
device: ``None`` = kernel on CUDA, plain on the CPU; ``True`` on a CPU
tensor raises; ``False`` on the card is the explicit A/B that
``chip_smoke.py`` uses.

Every launch adds one to ``LAUNCHES[name]`` (a plain integer per
kernel), so a run can show that the main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import inspect
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, ref

LAUNCHES: Dict[str, int] = {"pairwise_l2": 0, "build_cost": 0,
                            "delta_sweep": 0, "pairwise_l2_batched": 0,
                            "build_cost_from_feats": 0,
                            "delta_sweep_from_feats": 0,
                            "flash_attention": 0, "rmsnorm": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def resolve_use_kernel(use_kernel: Optional[bool],
                       device: torch.device) -> bool:
    """Resolve the tri-state kernel switch for tensors on ``device``."""
    on_cuda = torch.device(device).type == "cuda"
    if use_kernel is None:
        return on_cuda
    if use_kernel and not on_cuda:
        raise ValueError("use_kernel=True needs tensors on a CUDA device; "
                         "the CUDA kernels have no CPU mode")
    return bool(use_kernel)


def zero_self_diag(d: torch.Tensor) -> torch.Tensor:
    """Exact zeros on the self-distance diagonal of (..., M, M) stacks.

    ``‖a‖² + ‖b‖² − 2ab`` cancels imperfectly in float32; every
    self-distance consumer (k-medoids BUILD/SWAP) needs literal zeros."""
    m = d.shape[-1]
    return d * (1.0 - torch.eye(m, dtype=d.dtype, device=d.device))


def _check(name: str, t: torch.Tensor, shape, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, "
                         f"got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


# each kernel's ctypes entry point, resolved (and built) at its first launch
_FNS: Dict[str, object] = {}


def _launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel ``name`` on ``device``'s current stream: the entry
    point is resolved once, the raw stream handle taken once, and the
    device switched only when ``device`` is not the current one."""
    fn = _FNS.get(name)
    if fn is None:
        fn = _FNS[name] = _build.kernel_function(name)
    cur = torch.cuda.current_device()
    idx = cur if device.index is None else device.index
    stream = torch._C._cuda_getCurrentRawStream(idx)
    if idx == cur:
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(idx):
            rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1


def _contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_contiguous() else t.contiguous()


def pairwise_l2(x: torch.Tensor, y: Optional[torch.Tensor] = None, *,
                squared: bool = False, zero_diag: bool = False,
                use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Pairwise Euclidean distances (m, d) x (n, d) -> (m, n), fp32.

    ``zero_diag`` (self mode only) pins the self-distance diagonal to
    exact zeros for k-medoids consumers."""
    self_mode = y is None
    if not resolve_use_kernel(use_kernel, x.device):
        out = ref.pairwise_l2_ref(x, y, squared=squared)
        return zero_self_diag(out) if zero_diag and self_mode else out
    y = x if self_mode else y
    m, d = x.shape
    n = y.shape[0]
    _check("pairwise_l2 x", x, (m, d), x.device)
    _check("pairwise_l2 y", y, (n, d), x.device)
    xsq = torch.sum(x * x, dim=-1)
    ysq = xsq if self_mode else torch.sum(y * y, dim=-1)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if out.numel():
        _launch("pairwise_l2", x.device, x.data_ptr(), y.data_ptr(),
                xsq.data_ptr(), ysq.data_ptr(), out.data_ptr(), m, n, d,
                int(squared), int(zero_diag and self_mode))
    return out


def pairwise_l2_batched(x: torch.Tensor, *, squared: bool = False,
                        zero_diag: bool = False,
                        use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Per-client self-distance stacks (C, M, D) -> (C, M, M), fp32.

    The fleet engine's selection front end below the distance-free
    cutover.  ``zero_diag`` pins each client's self-distance diagonal to
    exact zeros for k-medoids consumers."""
    if not resolve_use_kernel(use_kernel, x.device):
        out = ref.pairwise_l2_batched_ref(x, squared=squared)
        return zero_self_diag(out) if zero_diag else out
    c, m, d = x.shape
    _check("pairwise_l2_batched x", x, (c, m, d), x.device)
    xsq = torch.sum(x * x, dim=-1)
    out = torch.empty((c, m, m), dtype=torch.float32, device=x.device)
    if out.numel():
        _launch("pairwise_l2_batched", x.device, x.data_ptr(),
                xsq.data_ptr(), out.data_ptr(), c, m, d, int(squared),
                int(zero_diag))
    return out


def kmedoids_build_cost(D: torch.Tensor, d_near: torch.Tensor,
                        vf: torch.Tensor, *,
                        use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Fused BUILD add-cost: D (C, M, M), d_near/vf (C, M) -> (C, M)."""
    if not resolve_use_kernel(use_kernel, D.device):
        return ref.kmedoids_build_cost_ref(D, d_near, vf)
    c, m = D.shape[0], D.shape[1]
    _check("build_cost D", D, (c, m, m), D.device)
    _check("build_cost d_near", d_near, (c, m), D.device)
    _check("build_cost vf", vf, (c, m), D.device)
    out = torch.empty((c, m), dtype=torch.float32, device=D.device)
    if out.numel():
        _launch("build_cost", D.device, D.data_ptr(), d_near.data_ptr(),
                vf.data_ptr(), out.data_ptr(), c, m)
    return out


def kmedoids_delta_sweep(D: torch.Tensor, d1: torch.Tensor, d2: torch.Tensor,
                         vf: torch.Tensor, n_onehot: torch.Tensor, *,
                         use_kernel: Optional[bool] = None):
    """Fused FasterPAM Δ-sweep reductions: one pass over D per sweep.

    D (C, M, M); d1/d2/vf (C, M); n_onehot (C, M, K).  Returns
    (A (C, M), B (C, M, K)) with Δ(j, l) = A[:, j] + B[:, j, l] — see
    ``ref.kmedoids_delta_sweep_ref`` for the math."""
    if not resolve_use_kernel(use_kernel, D.device):
        return ref.kmedoids_delta_sweep_ref(D, d1, d2, vf, n_onehot)
    c, m, k = D.shape[0], D.shape[1], n_onehot.shape[-1]
    _check("delta_sweep D", D, (c, m, m), D.device)
    for name, t in (("d1", d1), ("d2", d2), ("vf", vf)):
        _check(f"delta_sweep {name}", t, (c, m), D.device)
    _check("delta_sweep n_onehot", n_onehot, (c, m, k), D.device)
    A = torch.empty((c, m), dtype=torch.float32, device=D.device)
    B = torch.empty((c, m, k), dtype=torch.float32, device=D.device)
    if B.numel():
        _launch("delta_sweep", D.device, D.data_ptr(), d1.data_ptr(),
                d2.data_ptr(), vf.data_ptr(), n_onehot.data_ptr(),
                A.data_ptr(), B.data_ptr(), c, m, k)
    return A, B


def kmedoids_build_cost_from_feats(x: torch.Tensor, d_near: torch.Tensor,
                                   vf: torch.Tensor, *,
                                   use_kernel: Optional[bool] = None
                                   ) -> torch.Tensor:
    """Distance-free BUILD add-cost: x (C, M, F), d_near/vf (C, M) ->
    (C, M), with the (C, M, M) distance stack never stored on the kernel
    path.  Padded candidates (vf = 0) return +BIG, so a zero-padded
    feature row can never win the greedy argmin; padded rows add
    nothing."""
    if not resolve_use_kernel(use_kernel, x.device):
        return ref.kmedoids_build_cost_from_feats_ref(x, d_near, vf)
    c, m, f = x.shape
    _check("build_cost_from_feats x", x, (c, m, f), x.device)
    _check("build_cost_from_feats d_near", d_near, (c, m), x.device)
    _check("build_cost_from_feats vf", vf, (c, m), x.device)
    sq = torch.sum(x * x, dim=-1)
    out = torch.empty((c, m), dtype=torch.float32, device=x.device)
    if out.numel():
        _launch("build_cost_from_feats", x.device, x.data_ptr(),
                sq.data_ptr(), d_near.data_ptr(), vf.data_ptr(),
                out.data_ptr(), c, m, f)
    return out


def kmedoids_delta_sweep_from_feats(x: torch.Tensor, d1: torch.Tensor,
                                    d2: torch.Tensor, vf: torch.Tensor,
                                    n_onehot: torch.Tensor, *,
                                    use_kernel: Optional[bool] = None):
    """Distance-free FasterPAM Δ-sweep: x (C, M, F); d1/d2/vf (C, M);
    n_onehot (C, M, K).  Returns (A (C, M), B (C, M, K)) as
    ``kmedoids_delta_sweep`` on the feature stack's distances, with
    A = +BIG at padded candidates (vf = 0) so a zero-padded row can never
    win a swap."""
    if not resolve_use_kernel(use_kernel, x.device):
        return ref.kmedoids_delta_sweep_from_feats_ref(x, d1, d2, vf,
                                                       n_onehot)
    c, m, f = x.shape
    k = n_onehot.shape[-1]
    _check("delta_sweep_from_feats x", x, (c, m, f), x.device)
    for name, t in (("d1", d1), ("d2", d2), ("vf", vf)):
        _check(f"delta_sweep_from_feats {name}", t, (c, m), x.device)
    _check("delta_sweep_from_feats n_onehot", n_onehot, (c, m, k), x.device)
    sq = torch.sum(x * x, dim=-1)
    A = torch.empty((c, m), dtype=torch.float32, device=x.device)
    B = torch.empty((c, m, k), dtype=torch.float32, device=x.device)
    if B.numel():
        _launch("delta_sweep_from_feats", x.device, x.data_ptr(),
                sq.data_ptr(), d1.data_ptr(), d2.data_ptr(), vf.data_ptr(),
                n_onehot.data_ptr(), A.data_ptr(), B.data_ptr(), c, m, f, k)
    return A, B


# ---------------------------------------------------------------------------
# flash attention: one autograd.Function for every call
# ---------------------------------------------------------------------------

def _flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool,
                            window: Optional[int],
                            scale: float) -> torch.Tensor:
    """Launch ``csrc/flash_attention.cu`` on q/k/v on the card: bf16 on
    its tensor-core kernel (wgmma, TMA), fp32 on its SIMT kernel."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention: expected q (B, Hq, S, hd) and "
                         "k/v (B, Hk, S, hd)")
    b, hq, s, hd = q.shape
    hk = k.shape[1]
    if tuple(k.shape) != (b, hk, s, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if hk < 1 or hq % hk:
        raise ValueError(f"flash_attention: {hq} q heads are no multiple "
                         f"of {hk} kv heads")
    if not 1 <= hd <= 128:
        raise ValueError(f"flash_attention: head dim {hd} outside 1..128")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must all be float32 "
                        f"or all bfloat16, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v lie on different "
                         "devices")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    q, k, v = _contiguous(q), _contiguous(k), _contiguous(v)
    out = torch.empty((b, hq, s, hd), dtype=q.dtype, device=q.device)
    bf16 = q.dtype == torch.bfloat16
    ld = hd
    if bf16:      # TMA's rows: a multiple of 8 elements, 16-byte aligned
        ld = -(-hd // 8) * 8
        q, k, v = (_tma_rows(t, ld) for t in (q, k, v))
    if out.numel():
        _launch("flash_attention", q.device, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), b, hq, hk, s, hd, ld,
                int(causal), int(window or 0), int(bf16),
                ctypes.c_float(scale))
    return out


def _tma_rows(t: torch.Tensor, ld: int) -> torch.Tensor:
    """``t`` (..., hd) contiguous as the bf16 kernel's TMA reads it: rows
    of ``ld`` elements (zero columns past hd; TMA takes row strides in
    multiples of 16 bytes) from a 16-byte aligned address."""
    if t.shape[-1] != ld:
        return F.pad(t, (0, ld - t.shape[-1]))
    return t.clone() if t.data_ptr() % 16 else t


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, do: torch.Tensor, *,
                             causal: bool, window: Optional[int],
                             scale: float):
    """(dq, dk, dv) of ``flash_attention`` for the output gradient ``do``,
    in PyTorch tensor ops: recompute P = softmax(scale·QKᵀ, masked), then
    dV = Pᵀ·dO, dP = dO·Vᵀ, dS = P ∘ (dP − rowsum(P ∘ dP)),
    dQ = scale·dS·K and dK = scale·dSᵀ·Q, with GQA's kv-head gradients
    summed over the q heads that share them.  The matrix products go to
    ``torch.matmul``, as the JAX package leaves the gradient to XLA."""
    b, hq, s, hd = q.shape
    hk = k.shape[1]
    g = hq // hk
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    sc = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    ok = ref.attention_mask(s, causal, window, q.device)
    p = torch.softmax(torch.where(ok, sc, ref.NEG_INF), dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - torch.sum(p * dp, dim=-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dk = dk.reshape(b, hk, g, s, hd).sum(dim=2)
    dv = dv.reshape(b, hk, g, s, hd).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """Flash attention as one autograd.Function on every device.

    ``forward`` runs the plain version (``ref.flash_attention_ref``) or,
    with ``use_kernel``, the CUDA kernel.  ``backward`` is PyTorch tensor
    ops (``flash_attention_backward``): the JAX package's Pallas kernel
    defines no VJP, and ``jax.grad`` through its ``pallas_call`` fails, so
    the JAX package trains only through its naive attention, which XLA
    differentiates.  ``vmap`` folds the vmapped axis into B and applies
    the Function again, so under ``torch.func.vmap`` (the fleet engine's
    vmapped SGD step) the forward sees tensors with storage, which a
    kernel launch needs, and launches once for the whole batch."""

    @staticmethod
    def forward(q, k, v, causal, window, scale, use_kernel):
        if use_kernel:
            return _flash_attention_kernel(q, k, v, causal, window, scale)
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window, scale=scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, scale, _ = inputs
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, do, causal=ctx.causal, window=ctx.window,
            scale=ctx.scale)
        return dq, dk, dv, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, scale, use_kernel):
        n = info.batch_size

        def fold(t, dim):
            t = (t.expand((n,) + t.shape) if dim is None
                 else t.movedim(dim, 0))
            return t.reshape((n * t.shape[1],) + t.shape[2:])

        out = _FlashAttention.apply(fold(q, in_dims[0]), fold(k, in_dims[1]),
                                    fold(v, in_dims[2]), causal, window,
                                    scale, use_kernel)
        return out.reshape((n, -1) + out.shape[1:]), 0


def _keep_signature(fn: type) -> None:
    """``autograd.Function.apply`` binds its arguments to ``forward``'s
    signature at every call (``setup_context`` style), and
    ``inspect.signature`` builds that signature anew each time, a large
    part of a small call's host time: keep it on ``forward``, where
    ``inspect`` looks first."""
    fn.forward.__signature__ = inspect.signature(fn.forward)


_keep_signature(_FlashAttention)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None,
                    use_kernel: Optional[bool] = None) -> torch.Tensor:
    """q (B, Hq, S, hd), k/v (B, Hk, S, hd) -> (B, Hq, S, hd) in q's dtype.

    Causal (or, with ``causal=False``, full) attention with an optional
    sliding ``window`` (key k visible to query q when k > q − window),
    ``scale`` = 1/sqrt(hd) by default, GQA by kv head = q head //
    (Hq / Hk).  fp32 or bf16, accumulated in fp32.  Differentiable,
    under ``torch.func`` transforms too; the gradient is PyTorch ops
    (see ``_FlashAttention``)."""
    hd = q.shape[-1]
    scale = float(scale if scale is not None else 1.0 / (hd ** 0.5))
    uk = resolve_use_kernel(use_kernel, q.device)
    return _FlashAttention.apply(q, k, v, causal, window, scale, uk)


# ---------------------------------------------------------------------------
# RMSNorm: one autograd.Function for every call
# ---------------------------------------------------------------------------

def _rmsnorm_kernel(x: torch.Tensor, scale: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """Launch ``csrc/rmsnorm.cu`` (kernel 8, the port of the TPU kernel
    ``src/repro/kernels/rmsnorm.py::rmsnorm_pallas``) on x (G, m, d) and
    scale (G, d) on the card.  Bound by bytes: it reads x and the scale
    once and writes y once, 16 bytes a lane, a row's lanes on neighbouring
    vectors; nothing is padded (the TPU wrapper pads m to its row tile)."""
    if x.dim() != 3 or scale.dim() != 2 or \
            tuple(scale.shape) != (x.shape[0], x.shape[2]):
        raise ValueError(f"rmsnorm: expected x (G, m, d) and scale (G, d), "
                         f"got {tuple(x.shape)} and {tuple(scale.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rmsnorm: expected float32 or bfloat16 x, got "
                        f"{x.dtype}")
    if scale.device != x.device:
        raise ValueError("rmsnorm: x and scale lie on different devices")
    x = _contiguous(x)
    if scale.dtype != torch.float32 or not scale.is_contiguous():
        scale = scale.float().contiguous()
    g, m, d = x.shape
    inv_d, eps32 = ref.rmsnorm_constants(d, eps)
    out = torch.empty_like(x)
    if out.numel():
        _launch("rmsnorm", x.device, x.data_ptr(), scale.data_ptr(),
                out.data_ptr(), g, m, d, int(x.dtype == torch.bfloat16),
                ctypes.c_float(inv_d), ctypes.c_float(eps32))
    return out


def rmsnorm_backward(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                     *, eps: float):
    """(dx, dscale) of ``rmsnorm`` for x (G, m, d), scale (G, d) and the
    output gradient ``dy``, in float32 PyTorch tensor ops: with
    x̂ = x·rs and gs = dy·scale, dx = rs·(gs − x̂·mean(gs·x̂)), and
    dscale[g] = Σ over group g's rows of dy·x̂."""
    xf, dyf = x.float(), dy.float()
    rs = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xhat = xf * rs
    gs = dyf * scale.float()[..., None, :]
    dx = rs * (gs - xhat * torch.mean(gs * xhat, dim=-1, keepdim=True))
    dscale = torch.sum(dyf * xhat, dim=-2)
    return dx.to(x.dtype), dscale.to(scale.dtype)


class _RMSNorm(torch.autograd.Function):
    """RMSNorm over rows in groups, x (G, m, d) and scale (G, d), as one
    autograd.Function on every device.

    ``forward`` runs the plain version (``ref.rmsnorm_ref``) or, with
    ``use_kernel``, the CUDA kernel; the two agree bit for bit.
    ``backward`` is PyTorch tensor ops (``rmsnorm_backward``): the JAX
    package's Pallas kernel defines no VJP.  ``vmap`` moves the vmapped
    axis to the front of x and of the scale (expanding whichever is not
    batched) and folds it into G, so each vmapped client keeps its own
    scale, and applies the Function once: the forward sees tensors with
    storage, and a vmapped SGD step launches the kernel once."""

    @staticmethod
    def forward(x, scale, eps, use_kernel):
        if use_kernel:
            return _rmsnorm_kernel(x, scale, eps)
        return ref.rmsnorm_ref(x, scale, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, scale, eps, _ = inputs
        ctx.save_for_backward(x, scale)
        ctx.eps = eps

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_backward(x, scale, dy, eps=ctx.eps)
        return dx, dscale, None, None

    @staticmethod
    def vmap(info, in_dims, x, scale, eps, use_kernel):
        n = info.batch_size

        def front(t, dim):
            return (t.expand((n,) + t.shape) if dim is None
                    else t.movedim(dim, 0))

        x, scale = front(x, in_dims[0]), front(scale, in_dims[1])
        out = _RMSNorm.apply(x.reshape((-1,) + x.shape[2:]),
                             scale.reshape((-1,) + scale.shape[2:]), eps,
                             use_kernel)
        return out.reshape(x.shape), 0


_keep_signature(_RMSNorm)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5,
            use_kernel: Optional[bool] = None) -> torch.Tensor:
    """x·rsqrt(mean(x²) + eps)·scale over the last axis of x (..., d),
    fp32 or bf16, with scale (d,); the arithmetic in float32, the result
    in x's dtype.  The leading axes are flattened into rows.
    Differentiable, under ``torch.func`` transforms too; the gradient is
    PyTorch ops (see ``_RMSNorm``)."""
    d = x.shape[-1]
    if tuple(scale.shape) != (d,):
        raise ValueError(f"rmsnorm: scale {tuple(scale.shape)} does not "
                         f"fit x {tuple(x.shape)}")
    uk = resolve_use_kernel(use_kernel, x.device)
    out = _RMSNorm.apply(x.reshape(1, -1, d), scale.reshape(1, d),
                         float(eps), uk)
    return out.reshape(x.shape)
