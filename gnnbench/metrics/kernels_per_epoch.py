"""Device kernels launched per profiled epoch (the trainer's launch work),
counted from the trace; copies and fills are not kernels."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels) / ctx.trace_epochs
