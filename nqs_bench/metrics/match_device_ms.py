"""match_device_ms (device_trace, ms): per traced step, the union of the
device intervals launched from inside the step's nqs.match span
(`bench_qec`'s step: the tiered exact DP, K = 6 on every shot and K = 12 on
each chunk's heaviest, and its flags)."""
from nqs_bench import layer_spans


def read(ctx):
    return layer_spans.device_ms(ctx, "nqs.match")
