"""pscan_roofline (device_trace, %): the population scan's bound from its
shapes (`roofline/pscan.py`, at the peaks of `peaks.py`) over the traced
device time of its `population_scan_kernel` launches per traced step. None
where no such kernel ran (a sweep, or a program without it)."""
from nqs_bench import peaks, tracing
from nqs_bench.roofline import pscan

KERNEL = "population_scan_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    ev = tracing.kernels(ctx.trace["device"], KERNEL)
    if not ev:
        return None
    t = sum(b - a for a, b, *_ in ev) * 1e-6 / ctx.trace["steps"]
    D = int(ctx.config["hilbert_space_dim"]) ** 2
    n, P, n_seg = D * D, D * (D - 1) // 2, int(ctx.config["n_steps"])
    M, S = int(ctx.traffic["inputs"]["count"]), 5
    bound = peaks.bound_s(pscan.flops(M, S, n, n_seg), pscan.nbytes(M, S, n, P, n_seg))
    return 100.0 * bound / t
