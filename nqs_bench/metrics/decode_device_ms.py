"""decode_device_ms (device_trace, ms): per traced step, the union of the
device intervals launched from inside the step's nqs.decode span
(`qec/dem_decoder.DemBPDecoder._full`: both BP tiers with K3, the scoring and
the compaction between them)."""
from nqs_bench import layer_spans


def read(ctx):
    return layer_spans.device_ms(ctx, "nqs.decode")
