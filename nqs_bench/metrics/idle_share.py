"""idle_share (device_trace, %): 1 - union of kernel, memcpy and memset
intervals over their span, across the traced steps."""
from nqs_bench import tracing


def read(ctx):
    if ctx.trace is None:
        return None
    share = tracing.idle_share(ctx.trace["device"])
    return None if share is None else 100.0 * share
