"""Device ms per profiled epoch in matrix-multiply kernels (cuBLAS, cuBLASLt
and CUTLASS, by name)."""

PATTERNS = ("gemm", "gemv", "cutlass", "cublas", "xmma", "splitkreduce")


def is_gemm(name: str) -> bool:
    low = name.lower()
    return any(p in low for p in PATTERNS)


def read(ctx):
    if ctx.trace is None:
        return None
    s = ctx.trace.kernel_seconds(is_gemm)
    return s * 1e3 / ctx.trace_epochs if s > 0 else None
