"""Device ms per traced epoch in the kernels of ``loss.backward()``: those
launched inside ``trainer.backward``, autograd's engine thread included
(``gnnbench/phases.py``)."""

from gnnbench.phases import phase_ms


def read(ctx):
    return phase_ms(ctx, "trainer.backward")
