"""gemm_ms (ms): device time of the cuBLAS matrix products (kernels
whose name holds ``gemm``) in the profiled round: the LM step's
projections, MLP, output layer and the attention backward's products."""


def read(ctx):
    p = ctx.profiled
    if p is None:
        return None
    s = sum(v[1] for n, v in p.ops_by_name.items() if "gemm" in n.lower())
    return 1e3 * s if s > 0 else None
