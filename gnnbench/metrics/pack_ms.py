"""Host ms per traced epoch inside the trainer's ``mol.pack`` spans: packing
each train batch of molecules on the host (``gnnbench/steps.py``)."""

from gnnbench.steps import host_ms


def read(ctx):
    return host_ms(ctx, "mol.pack")
