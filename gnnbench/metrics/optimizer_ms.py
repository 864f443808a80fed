"""Device ms per traced epoch in the optimizer's step (``trainer.optimizer``:
Adam, or the teacher's ``RMSpropWarmup``; ``gnnbench/phases.py``)."""

from gnnbench.phases import phase_ms


def read(ctx):
    return phase_ms(ctx, "trainer.optimizer")
