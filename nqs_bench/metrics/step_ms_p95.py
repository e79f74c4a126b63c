"""step_ms_p95 (host clock): the 95th percentile of the steps' durations,
each from enqueue until its outputs are on the host."""
import numpy as np


def read(ctx):
    return 1e3 * float(np.percentile(ctx.durations, 95)) if ctx.durations else None
