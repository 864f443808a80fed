"""The least time of the epoch's SpMM work (``work.py``, counted from the
configuration's shapes) over the device time of the kernels that carry it,
K1's two kernels by name, in %. K2 instantiates the same kernel template:
a cell that runs K2 needs a reader of its own."""

K1 = ("split_segment_sum_kernel", "split_reduce_kernel")


def read(ctx):
    if ctx.trace is None or not ctx.work.get("spmm_calls"):
        return None
    s = ctx.trace.kernel_seconds(lambda n: any(k in n for k in K1))
    if s <= 0:
        return None
    return 100.0 * ctx.work["spmm_least_s"] * ctx.trace_epochs / s
