"""Model FLOPs of an epoch (``work.py``: matrix products forward and
backward and ``2 E F`` an SpMM, from the configuration's shapes) over the
untraced window's ``epoch_ms`` times the H100 SXM's 67 TFLOP/s float32
peak, in %."""

from gnnbench.work import FP32_FLOP_PER_S


def read(ctx):
    if not ctx.epochs or not ctx.work.get("flops"):
        return None
    return 100.0 * ctx.work["flops"] / (ctx.epoch_ms / 1e3 * FP32_FLOP_PER_S)
