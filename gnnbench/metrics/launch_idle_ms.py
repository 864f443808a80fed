"""Device idle ms per traced epoch while the host issued the epoch: the
gaps between device intervals whose middle lies inside a ``trainer.epoch``
span and outside ``trainer.readback`` (``gnnbench/phases.py``)."""

from gnnbench.phases import for_context


def read(ctx):
    ph = for_context(ctx)
    return None if ph is None else ph.launch_idle_s * 1e3 / ctx.trace_epochs
