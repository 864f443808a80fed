"""``torch.cuda.max_memory_allocated()`` over the run up to the window's
close, set-up included, in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2.0**30 if ctx.peak_bytes else None
