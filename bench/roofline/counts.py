"""Operations and bytes of the port's kernels, counted from the shapes of
a call: the work the algorithm needs, whatever implements it.  Distances
count each client's triangle, m(m+1)/2 terms (the other half is its
mirror image); k-medoids counts the M, k and sweeps these inputs take.

Kernel numbers are the port's (PERF.md's table): 2 BUILD add-cost over
D, 3 Δ-sweep over D, 4 batched pairwise distances, 5 and 6 the
distance-free BUILD and Δ-sweep from the features, 7 flash attention,
8 RMSNorm.  Each function returns (bytes, operations)."""
from __future__ import annotations

from typing import List, Tuple

# the port's workspace cap of kernels 5 and 6 (kernels/ops.py
# FROM_FEATS_WORKSPACE_BYTES): a call runs in pieces of at most this many
# bytes of float32 distances
FROM_FEATS_WORKSPACE_BYTES = 64 << 20


def pairwise_l2(m: int, d: int) -> Tuple[float, float]:
    """Kernel 1: (m, d) -> (m, m) squared distances: the norms, a
    multiply-add a term and the 4-operation epilogue over the triangle."""
    tri = m * (m + 1) / 2
    return 4.0 * (m * d + m * m), 2.0 * m * d + tri * (2.0 * d + 4.0)


def pairwise_l2_batched(c: int, m: int, d: int) -> Tuple[float, float]:
    """Kernel 4: C clients' (M, d) -> (C, M, M) distances; the epilogue
    adds a square root."""
    tri = c * m * (m + 1) / 2
    return (4.0 * (c * m * d + c * m * m),
            2.0 * c * m * d + tri * (2.0 * d + 5.0))


def build_cost(c: int, m: int) -> Tuple[float, float]:
    """Kernel 2: D (C, M, M) once, d_near and vf in, the cost out; 3
    operations an element."""
    return 4.0 * (c * m * m + 3 * c * m), 3.0 * c * m * m


def delta_sweep(c: int, m: int, k: int, nnz: float) -> Tuple[float, float]:
    """Kernel 3: D, the (C, M, k) one-hot H and B once; 8 elementwise
    operations and one A add per (i, j), a multiply and an add per
    nonzero of H and j."""
    return (4.0 * c * (m * m + 4 * m + 2 * m * k),
            9.0 * c * m * m + 2.0 * nnz * m)


def build_cost_from_feats(c: int, m: int, f: int) -> Tuple[float, float]:
    """Kernel 5: the features and (C, M) rows once; the norms, the
    triangle's 2F dot and 5 epilogue operations, 3 BUILD operations a
    pair."""
    tri = c * m * (m + 1) / 2
    return (4.0 * (c * m * f + 3 * c * m),
            2.0 * c * m * f + tri * (2.0 * f + 5.0) + 3.0 * c * m * m)


def delta_sweep_from_feats(c: int, m: int, f: int, k: int, nnz: float
                           ) -> Tuple[float, float]:
    """Kernel 6: the features, the (C, M) rows, H and B once; the
    norms and the triangle as kernel 5's, 4 A and 4 contrib operations a
    pair, a multiply-add per one-hot nonzero and j."""
    tri = c * m * (m + 1) / 2
    return (4.0 * (c * m * f + 4 * c * m + 2 * c * m * k),
            2.0 * c * m * f + tri * (2.0 * f + 5.0) + 8.0 * c * m * m
            + 2.0 * nnz * m)


def from_feats_pieces(c: int, m: int,
                      cap_bytes: int = FROM_FEATS_WORKSPACE_BYTES
                      ) -> List[Tuple[int, int, int, int]]:
    """The pieces (clients [c0, c1), rows [r0, r1)) in which kernels 5
    and 6 take one call: whole clients as many as the cap holds, or one
    client in bands of rows.  Each piece is one launch of each of the
    call's device kernels."""
    per_client = 4 * m * m
    if per_client <= cap_bytes:
        step = cap_bytes // per_client
        return [(c0, min(c, c0 + step), 0, m) for c0 in range(0, c, step)]
    rows = cap_bytes // (4 * m)
    return [(i, i + 1, r0, min(m, r0 + rows)) for i in range(c)
            for r0 in range(0, m, rows)]


def flash_attention_gqa(b: int, hq: int, hk: int, s: int, d: int,
                        causal: bool = True, bytes_per: int = 4
                        ) -> Tuple[float, float]:
    """Kernel 7 forward with grouped heads: q and o at ``hq`` heads, k and
    v at ``hk``, each once; QKᵀ and PV at 2·d operations a pair of the
    causal half."""
    pairs = s * (s + 1) / 2 if causal else float(s * s)
    nbytes = bytes_per * b * s * d * (2 * hq + 2 * hk)
    return float(nbytes), 4.0 * b * hq * pairs * d


def rmsnorm(rows: int, d: int, bytes_per: int = 4) -> Tuple[float, float]:
    """Kernel 8 forward: x and the scale read once, y written once; a
    square-add a column, the mean and reciprocal square root a row, two
    multiplies a column."""
    return (float(bytes_per * (2 * rows * d + d)),
            4.0 * rows * d + 2.0 * rows)
