"""Device ms per traced epoch in the loss: the kernels launched inside
``trainer.criterion`` (the loss from the logits and features, the heads and
InfoNCE where the mode has them), plus the backward of those operations,
found by autograd's sequence numbers; that part is also in ``backward_ms``
(``gnnbench/phases.py``)."""

from gnnbench.phases import for_context


def read(ctx):
    ph = for_context(ctx)
    if ph is None:
        return None
    return (ph.owned_s["trainer.criterion"] + ph.criterion_backward_s) * 1e3 / ctx.trace_epochs
