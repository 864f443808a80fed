"""Wall time of the measured window over the epochs it completed (host
clock, from the window's start to a synchronisation after its last chunk)."""


def read(ctx):
    return ctx.epoch_ms if ctx.epochs else None
