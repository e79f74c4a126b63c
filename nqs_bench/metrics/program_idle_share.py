"""program_idle_share (device_trace, %): the traced steps' device idle time
whose gap begins while the host is inside an nqs.step span (the program
between its launches), over the same device span that `idle_share` divides
by. The rest of `idle_share` is the caller's: the inputs' draw, the
readback."""
from nqs_bench import program_spans, tracing


def read(ctx):
    v = program_spans.view(ctx)
    if v is None:
        return None
    _, span = tracing.busy_span(ctx.trace["device"])
    if span <= 0:
        return None
    return 100.0 * program_spans.program_idle_us(v, ctx.trace["device"]) / span
