"""scan_device_ms (device_trace, ms): per traced step, the union of the
device intervals (kernel, memcpy, memset) launched from inside an nqs.scan
span, each matched to its launch by `args.correlation`: how long the card
takes to run the scan."""
from nqs_bench import program_spans


def read(ctx):
    v = program_spans.view(ctx)
    if v is None:
        return None
    busy = sum(b - a for a, b in program_spans.scan_device(v))
    return 1e-3 * busy / len(v.steps)
