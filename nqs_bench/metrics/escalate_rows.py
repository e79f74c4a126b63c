"""escalate_rows (program_span, rows): the rows that the traced steps'
nqs.escalate spans decoded on the host (the count each carries), a step: the
shots that the tiered DP did not decode with all their defects."""
from nqs_bench import layer_spans


def read(ctx):
    return layer_spans.count(ctx, "nqs.escalate")
