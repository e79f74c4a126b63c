"""k1_roofline (device_trace, %): K1's bound from its shapes
(`roofline/k1.py`, at the peaks of `peaks.py`) over the traced device time
of one `phase_scan_tc_kernel` launch."""
from nqs_bench import peaks, tracing
from nqs_bench.roofline import k1

KERNEL = "phase_scan_tc_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    ev = tracing.kernels(ctx.trace["device"], KERNEL)
    if not ev:
        return None
    t = sum(b - a for a, b, *_ in ev) * 1e-6 / len(ev)
    D = int(ctx.config["hilbert_space_dim"]) ** 2
    n, P, n_seg = D * D, D * (D - 1) // 2, int(ctx.config["n_steps"])
    B, S = int(ctx.traffic["inputs"]["count"]), 5
    bound = peaks.bound_s(k1.flops(B, S, n, n_seg), k1.nbytes(B, S, n, P, n_seg))
    return 100.0 * bound / t
