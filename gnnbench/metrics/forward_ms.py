"""Device ms per traced epoch in the kernels launched inside the trainer's
``trainer.forward`` span: the train forward, the teacher's label reuse
included (``gnnbench/phases.py``)."""

from gnnbench.phases import phase_ms


def read(ctx):
    return phase_ms(ctx, "trainer.forward")
