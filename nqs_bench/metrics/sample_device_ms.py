"""sample_device_ms (device_trace, ms): per traced step, the union of the
device intervals launched from inside the step's nqs.sample span
(`qec/fast_sampler`: the fault draws and the signature products)."""
from nqs_bench import layer_spans


def read(ctx):
    return layer_spans.device_ms(ctx, "nqs.sample")
