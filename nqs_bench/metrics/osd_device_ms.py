"""osd_device_ms (device_trace, ms): per traced step, the union of the
device intervals launched from inside the step's nqs.osd span (`bench_bb`:
the OSD-0 kernel on the residue rows, the scatter of their predictions and
the failures' sum)."""
from nqs_bench import layer_spans


def read(ctx):
    return layer_spans.device_ms(ctx, "nqs.osd")
