"""kernels_per_step (device_trace, launches): device kernel events in the
trace over the traced steps."""
from nqs_bench import tracing


def read(ctx):
    if ctx.trace is None:
        return None
    n = len(tracing.kernels(ctx.trace["device"]))
    return n / ctx.trace["steps"] if n else None
