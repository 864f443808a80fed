"""Device ms per profiled epoch in PyTorch's own kernels other than matrix
products: elementwise, reductions, BatchNorm, softmax, index ops, the
optimizer step. The program's hand-written kernels (K1-K7, by their names
below) and copies and fills are not counted."""

from gnnbench.metrics.gemm_ms import is_gemm

PORT_KERNELS = ("split_segment_sum_kernel", "split_reduce_kernel", "split_sddmm_kernel",
                "thin_reduce_units_kernel", "thin_reduce_long_kernel",
                "tile_rows_thin_kernel", "empty_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    s = ctx.trace.kernel_seconds(
        lambda n: not is_gemm(n) and not any(k in n for k in PORT_KERNELS))
    return s * 1e3 / ctx.trace_epochs if s > 0 else None
