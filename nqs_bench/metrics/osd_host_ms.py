"""osd_host_ms (program_span, ms): the host's time inside the traced steps'
nqs.osd spans (`bench_bb`: the residue's copy to the host and the native
OSD-0 on it), a step."""
from nqs_bench import layer_spans


def read(ctx):
    return layer_spans.host_ms(ctx, "nqs.osd")
