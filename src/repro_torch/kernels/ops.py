"""Public wrappers around the selection kernels.

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

from typing import Dict, Optional

import torch

from repro_torch.kernels import ref

LAUNCHES: Dict[str, int] = {"pairwise_l2": 0, "build_cost": 0,
                            "delta_sweep": 0, "pairwise_l2_batched": 0,
                            "build_cost_from_feats": 0,
                            "delta_sweep_from_feats": 0}


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


def _launch(name: str, device: torch.device, *args) -> None:
    from repro_torch.kernels._build import kernel_function
    fn = kernel_function(name)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1


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
