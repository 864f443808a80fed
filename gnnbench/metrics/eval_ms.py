"""Device ms per traced epoch in the evaluation (``trainer.eval``: the eval
forward, the accuracies and the epoch's row of statistics, and in the
teacher the best-validation tracking; ``gnnbench/phases.py``)."""

from gnnbench.phases import phase_ms


def read(ctx):
    return phase_ms(ctx, "trainer.eval")
