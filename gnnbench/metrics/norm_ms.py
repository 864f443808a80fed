"""Device ms per profiled epoch in MaskedBatchNorm's kernels
(``csrc/masked_bn.cu``: every kernel whose name holds ``masked_bn_``),
forward, backward and eval. A program without them reads None. They count
in ``elementwise_ms`` too."""

NAME = "masked_bn_"


def read(ctx):
    if ctx.trace is None:
        return None
    s = ctx.trace.kernel_seconds(lambda n: NAME in n)
    return s * 1e3 / ctx.trace_epochs if s > 0 else None
