"""scan_host_ms (program_span, ms): the host's time inside the traced steps'
nqs.scan spans (`solver/real_rep`: K1, or the population's per-member scan)
per traced step: how long the host takes to enqueue the scan."""
from nqs_bench import program_spans


def read(ctx):
    v = program_spans.view(ctx)
    if v is None:
        return None
    return 1e-3 * sum(b - a for a, b in v.scans) / len(v.steps)
