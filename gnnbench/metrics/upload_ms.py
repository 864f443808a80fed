"""Host ms per traced epoch inside the trainer's ``mol.upload`` spans:
copying each packed train batch to the device (``gnnbench/steps.py``)."""

from gnnbench.steps import host_ms


def read(ctx):
    return host_ms(ctx, "mol.upload")
