"""osd_rows (program_span, rows): the residue rows that the traced steps'
nqs.osd spans decoded (the count each carries), a step: the shots that both
BP tiers left unconverged."""
from nqs_bench import layer_spans


def read(ctx):
    return layer_spans.count(ctx, "nqs.osd")
