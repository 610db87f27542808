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
import functools
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


def _call(name: str, device: torch.device, *args) -> None:
    """Call kernel ``name``'s entry point on ``device``'s current stream:
    the entry point is resolved once, the raw stream handle taken once,
    and the device switched only when ``device`` is not the current one.
    Raises on a launch error."""
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


def _launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel ``name`` on ``device``'s current stream (``_call``)
    and count the launch."""
    _call(name, device, *args)
    LAUNCHES[name] += 1


def _contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_contiguous() else t.contiguous()


# tile configurations of csrc/pairwise_l2.cu, in the order of its
# ``dispatch``: (rows of a square output tile, rows of a thread's square
# register block); a block has (rows / block rows)² threads
PAIRWISE_TILES = ((32, 4), (16, 2))


@functools.lru_cache(maxsize=None)
def card_sms(device: torch.device) -> int:
    """Streaming multiprocessors of the CUDA card ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def pairwise_grid(c: int, m: int, n: int, tile: int,
                  self_mode: bool) -> int:
    """Blocks the pairwise kernel launches for ``c`` clients' (m, n)
    outputs at tile configuration ``tile``: one per output tile, only the
    upper triangle's (tile-col >= tile-row) in self mode, where each
    off-diagonal tile also writes its mirror image."""
    bm = PAIRWISE_TILES[tile][0]
    ntr, ntc = -(-m // bm), -(-n // bm)
    return c * (ntr * (ntr + 1) // 2 if self_mode else ntr * ntc)


def pairwise_tile(c: int, m: int, n: int, self_mode: bool, sms: int) -> int:
    """The tile configuration of the pairwise kernel for ``c`` clients'
    (m, n) outputs on a card of ``sms`` SMs, read from the grid alone:
    32-row tiles (two warps a block) where they give every SM two blocks,
    a warp for each of its four schedulers; else 16-row tiles, four times
    the blocks (``tools/pairwise_tiles.py --tiles`` times both).  Each
    output sums over d in order in both, so either gives the same bits."""
    return 0 if pairwise_grid(c, m, n, 0, self_mode) >= 2 * sms else 1


def pairwise_l2(x: torch.Tensor, y: Optional[torch.Tensor] = None, *,
                squared: bool = False, zero_diag: bool = False,
                use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Pairwise Euclidean distances (m, d) x (n, d) -> (m, n), fp32.

    ``zero_diag`` (self mode only) pins the self-distance diagonal to
    exact zeros for k-medoids consumers.  Without ``y`` (self mode) the
    kernel computes the upper triangle of tiles and mirrors it."""
    if not resolve_use_kernel(use_kernel, x.device):
        out = ref.pairwise_l2_ref(x, y, squared=squared)
        return zero_self_diag(out) if zero_diag and y is None else out
    return _pairwise_l2_launch(x, y, squared, zero_diag, None)


def _pairwise_tile(tile: Optional[int], c: int, m: int, n: int,
                   self_mode: bool, device: torch.device) -> int:
    """``tile``, or the chooser's where it is ``None``; raises for a tile
    the kernel does not have and for a tensor off the card."""
    if tile is not None and not 0 <= tile < len(PAIRWISE_TILES):
        raise ValueError(f"pairwise tile {tile}: expected an index of "
                         f"PAIRWISE_TILES {PAIRWISE_TILES}")
    if device.type != "cuda":
        raise ValueError(f"the pairwise kernel needs tensors on a CUDA "
                         f"device, got {device}")
    if tile is None:
        return pairwise_tile(c, m, n, self_mode, card_sms(device))
    return tile


def _pairwise_l2_launch(x: torch.Tensor, y: Optional[torch.Tensor],
                        squared: bool, zero_diag: bool,
                        tile: Optional[int]) -> torch.Tensor:
    """Kernel 1 on the card at tile configuration ``tile`` (an index of
    ``PAIRWISE_TILES``; ``None``: ``pairwise_tile``'s).  No tile changes a
    bit of the result; the card tests and ``tools/pairwise_tiles.py``
    force each one."""
    self_mode = y is None
    y = x if self_mode else y
    m, d = x.shape
    n = y.shape[0]
    _check("pairwise_l2 x", x, (m, d), x.device)
    _check("pairwise_l2 y", y, (n, d), x.device)
    tile = _pairwise_tile(tile, 1, m, n, self_mode, x.device)
    xsq = torch.sum(x * x, dim=-1)
    ysq = xsq if self_mode else torch.sum(y * y, dim=-1)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if out.numel():
        _launch("pairwise_l2", x.device, x.data_ptr(), y.data_ptr(),
                xsq.data_ptr(), ysq.data_ptr(), out.data_ptr(), m, n, d,
                int(squared), int(zero_diag and self_mode), int(self_mode),
                tile)
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
    return _pairwise_l2_batched_launch(x, squared, zero_diag, None)


def _pairwise_l2_batched_launch(x: torch.Tensor, squared: bool,
                                zero_diag: bool,
                                tile: Optional[int]) -> torch.Tensor:
    """Kernel 4 on the card at tile configuration ``tile``, as
    ``_pairwise_l2_launch``."""
    c, m, d = x.shape
    _check("pairwise_l2_batched x", x, (c, m, d), x.device)
    tile = _pairwise_tile(tile, c, m, m, True, x.device)
    xsq = torch.sum(x * x, dim=-1)
    out = torch.empty((c, m, m), dtype=torch.float32, device=x.device)
    if out.numel():
        _launch("pairwise_l2_batched", x.device, x.data_ptr(),
                xsq.data_ptr(), out.data_ptr(), c, m, d, int(squared),
                int(zero_diag), tile)
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
    ``ref.kmedoids_delta_sweep_ref`` for the math.  On the card B costs
    one term for each nonzero of ``n_onehot`` and j (any ``n_onehot``;
    D, d1 and d2 finite): three launches, one counted."""
    if not resolve_use_kernel(use_kernel, D.device):
        return ref.kmedoids_delta_sweep_ref(D, d1, d2, vf, n_onehot)
    c, m, k = D.shape[0], D.shape[1], n_onehot.shape[-1]
    _check("delta_sweep D", D, (c, m, m), D.device)
    for name, t in (("d1", d1), ("d2", d2), ("vf", vf)):
        _check(f"delta_sweep {name}", t, (c, m), D.device)
    _check("delta_sweep n_onehot", n_onehot, (c, m, k), D.device)
    A = torch.empty((c, m), dtype=torch.float32, device=D.device)
    B = torch.empty((c, m, k), dtype=torch.float32, device=D.device)
    # the slot lists' scratch, one allocation: each slot's count, then
    # room for M rows a slot; sized from the shapes alone, so no count is
    # read back to the host
    lists = torch.empty(c * k * (m + 1), dtype=torch.int32, device=D.device)
    if A.numel():
        _launch("delta_sweep", D.device, D.data_ptr(), d1.data_ptr(),
                d2.data_ptr(), vf.data_ptr(), n_onehot.data_ptr(),
                A.data_ptr(), B.data_ptr(), lists.data_ptr() + 4 * c * k,
                lists.data_ptr(), c, m, k)
    return A, B


# bytes of distances a call of kernels 5 and 6 may hold in its workspace:
# 4x the largest (C, M, M) stack of the main paths (16.8 MB at C = 1,
# M = 2048); a cohort whose stack is larger runs in pieces
# (``from_feats_plan``)
FROM_FEATS_WORKSPACE_BYTES = 64 << 20


def from_feats_plan(c: int, m: int, cap_bytes: int):
    """The pieces in which kernels 5 and 6 take a cohort of ``c`` clients
    of ``m`` rows with at most ``cap_bytes`` of float32 distances at a
    time: ``(c0, c1, r0, r1)``, clients [c0, c1) and rows [r0, r1) of
    each one's M x M matrix, in order.  Whole clients in chunks as large
    as the cap allows; where one client's M x M alone is larger, that
    client in bands of rows, each continuing the sums of the band before.
    No piece changes a bit of the result."""
    per_client = 4 * m * m
    if per_client <= cap_bytes:
        step = cap_bytes // per_client
        return [(c0, min(c, c0 + step), 0, m) for c0 in range(0, c, step)]
    rows = cap_bytes // (4 * m)
    if rows < 1:
        raise ValueError(f"a workspace of {cap_bytes} bytes holds no row "
                         f"of {m} distances")
    return [(i, i + 1, r0, min(m, r0 + rows)) for i in range(c)
            for r0 in range(0, m, rows)]


def _from_feats_launch(name: str, x: torch.Tensor, cap_bytes: int,
                       tensors, k=()) -> None:
    """Run kernel ``name`` (5 or 6) on the card over the pieces of
    ``from_feats_plan``: one call of its entry point a piece, with the
    piece's first client's address in each of ``tensors`` (each holding
    (C, M, ...) contiguous), the workspace, the piece's clients, M, F,
    ``k`` and its rows.  The workspace comes from the caching allocator
    and holds the largest piece.  Counts one launch."""
    c, m, f = x.shape
    pieces = from_feats_plan(c, m, cap_bytes)
    ws = torch.empty(max((c1 - c0) * (r1 - r0) * m
                         for c0, c1, r0, r1 in pieces),
                     dtype=torch.float32, device=x.device)
    ptrs = [(t.data_ptr(), t.element_size() * (t.numel() // c))
            for t in tensors]
    sms = card_sms(x.device)
    for c0, c1, r0, r1 in pieces:
        tile = pairwise_tile(c1 - c0, r1 - r0, m, r0 == 0 and r1 == m, sms)
        _call(name, x.device, *[p + c0 * s for p, s in ptrs], ws.data_ptr(),
              c1 - c0, m, f, *k, r0, r1 - r0, tile)
    LAUNCHES[name] += 1


def _from_feats_norms(name: str, x: torch.Tensor, *rows) -> torch.Tensor:
    """Check kernel 5's or 6's features and (C, M) inputs on the card;
    returns the squared row norms, as the plain version computes them."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} needs tensors on a CUDA device, got "
                         f"{x.device}")
    c, m, f = x.shape
    _check(f"{name} x", x, (c, m, f), x.device)
    for what, t in rows:
        _check(f"{name} {what}", t, (c, m), x.device)
    return torch.sum(x * x, dim=-1)


def kmedoids_build_cost_from_feats(x: torch.Tensor, d_near: torch.Tensor,
                                   vf: torch.Tensor, *,
                                   use_kernel: Optional[bool] = None
                                   ) -> torch.Tensor:
    """Distance-free BUILD add-cost: x (C, M, F), d_near/vf (C, M) ->
    (C, M); on the kernel path the (C, M, M) distance stack takes at
    most ``FROM_FEATS_WORKSPACE_BYTES`` at a time.  Padded candidates
    (vf = 0) return +BIG, so a zero-padded feature row can never win the
    greedy argmin; padded rows add nothing."""
    if not resolve_use_kernel(use_kernel, x.device):
        return ref.kmedoids_build_cost_from_feats_ref(x, d_near, vf)
    return _build_cost_from_feats_launch(x, d_near, vf,
                                         FROM_FEATS_WORKSPACE_BYTES)


def _build_cost_from_feats_launch(x: torch.Tensor, d_near: torch.Tensor,
                                  vf: torch.Tensor,
                                  cap_bytes: int) -> torch.Tensor:
    """Kernel 5 on the card with a workspace of at most ``cap_bytes``;
    the card tests force small caps through it."""
    sq = _from_feats_norms("build_cost_from_feats", x, ("d_near", d_near),
                           ("vf", vf))
    out = torch.empty(x.shape[:2], dtype=torch.float32, device=x.device)
    if out.numel():
        _from_feats_launch("build_cost_from_feats", x, cap_bytes,
                           (x, sq, d_near, vf, out))
    return out


def kmedoids_delta_sweep_from_feats(x: torch.Tensor, d1: torch.Tensor,
                                    d2: torch.Tensor, vf: torch.Tensor,
                                    n_onehot: torch.Tensor, *,
                                    use_kernel: Optional[bool] = None):
    """Distance-free FasterPAM Δ-sweep: x (C, M, F); d1/d2/vf (C, M);
    n_onehot (C, M, K).  Returns (A (C, M), B (C, M, K)) as
    ``kmedoids_delta_sweep`` on the feature stack's distances, with
    A = +BIG at padded candidates (vf = 0) so a zero-padded row can never
    win a swap; on the kernel path the distances take at most
    ``FROM_FEATS_WORKSPACE_BYTES`` at a time."""
    if not resolve_use_kernel(use_kernel, x.device):
        return ref.kmedoids_delta_sweep_from_feats_ref(x, d1, d2, vf,
                                                       n_onehot)
    return _delta_sweep_from_feats_launch(x, d1, d2, vf, n_onehot,
                                          FROM_FEATS_WORKSPACE_BYTES)


def _delta_sweep_from_feats_launch(x: torch.Tensor, d1: torch.Tensor,
                                   d2: torch.Tensor, vf: torch.Tensor,
                                   n_onehot: torch.Tensor, cap_bytes: int):
    """Kernel 6 on the card with a workspace of at most ``cap_bytes``;
    the card tests force small caps through it."""
    sq = _from_feats_norms("delta_sweep_from_feats", x, ("d1", d1),
                           ("d2", d2), ("vf", vf))
    c, m, _ = x.shape
    k = n_onehot.shape[-1]
    _check("delta_sweep_from_feats n_onehot", n_onehot, (c, m, k), x.device)
    A = torch.empty((c, m), dtype=torch.float32, device=x.device)
    B = torch.empty((c, m, k), dtype=torch.float32, device=x.device)
    if A.numel():
        _from_feats_launch("delta_sweep_from_feats", x, cap_bytes,
                           (x, sq, d1, d2, vf, n_onehot, A, B), (k,))
    return A, B


# ---------------------------------------------------------------------------
# flash attention: one autograd.Function for every call
# ---------------------------------------------------------------------------

# the largest head dim of each kernel path: the fp32 SIMT kernel's widest
# instance, and the bf16 kernel's two 64-column regions of a tile
FLASH_MAX_HEAD_DIM = {"fp32": 160, "bf16": 128}


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
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must all be float32 "
                        f"or all bfloat16, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    bf16 = q.dtype == torch.bfloat16
    max_hd = FLASH_MAX_HEAD_DIM["bf16" if bf16 else "fp32"]
    if not 1 <= hd <= max_hd:
        raise ValueError(f"flash_attention: head dim {hd} outside 1.."
                         f"{max_hd} for {q.dtype} (the kernel's limit)")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v lie on different "
                         "devices")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    q, k, v = _contiguous(q), _contiguous(k), _contiguous(v)
    out = torch.empty((b, hq, s, hd), dtype=q.dtype, device=q.device)
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
