"""Device kernels launched inside the trainer's ``trainer.step`` spans, over
the steps of the traced chunk: the launch work of one Adam step on one
batch, its backward included (``gnnbench/steps.py``)."""

from gnnbench.steps import for_context


def read(ctx):
    st = for_context(ctx)
    if st is None or not st.steps:
        return None
    return st.step_kernels / st.steps
