"""k2_roofline (device_trace, %): K2's bound over the traced steps (their
members' squaring counts from their own generators, `roofline/k2.py`) over
the traced device time of the `masked_square_*_kernel` launches. Read where
a step is one population objective call: each member has its own
generator."""
from nqs_bench import peaks, tracing
from nqs_bench.roofline import k2

KERNEL = "masked_square_"


def read(ctx):
    if ctx.trace is None or ctx.traffic["entry"] != "population":
        return None
    ev = tracing.kernels(ctx.trace["device"], KERNEL)
    if not ev:
        return None
    t = sum(b - a for a, b, *_ in ev) * 1e-6
    N = int(ctx.config["hilbert_space_dim"]) ** 4
    bound = 0.0
    for params in ctx.trace["inputs"]:
        s = k2.population_squarings(ctx.config, params)
        bound += peaks.bound_s(k2.flops(s, N), k2.nbytes(len(s), N, 4))
    return 100.0 * bound / t
