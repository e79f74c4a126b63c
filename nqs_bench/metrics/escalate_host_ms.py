"""escalate_host_ms (program_span, ms): the host's time inside the traced
steps' nqs.escalate spans (`bench_qec`'s step: the flagged rows' copy to the
host, their native exact decode and the scatter of their answers), a step."""
from nqs_bench import layer_spans


def read(ctx):
    return layer_spans.host_ms(ctx, "nqs.escalate")
