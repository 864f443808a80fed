"""Share of the profiled window in which no kernel, copy or fill ran (the
union of the device intervals), in %."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
