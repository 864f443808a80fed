"""95th percentile of the window's epoch durations: CUDA events recorded on
the stream at each epoch's start (and after the last), read after the
window, so a stall or a chunk boundary shows here."""

import numpy as np


def read(ctx):
    d = ctx.epoch_durations_s
    return float(np.percentile(d, 95)) * 1e3 if len(d) else None
