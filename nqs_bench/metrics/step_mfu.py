"""step_mfu (host_clock, %): the whole step's products (`roofline/step.py`)
at the 32-bit product peak, over the time per step of the window's
unprofiled steps (each from its call to its answers on the host). Bounds the
kernels' rooflines: a kernel taken off the path leaves its own share silent,
not this one. The products per step are those of the traced steps' inputs."""
from nqs_bench import peaks
from nqs_bench.roofline import k2, step


def read(ctx):
    if ctx.trace is None:
        return None
    entry = ctx.traffic["entry"]
    N = int(ctx.config["hilbert_space_dim"]) ** 4
    total = 0.0
    for x in ctx.trace["inputs"]:
        sq = (k2.flops(k2.population_squarings(ctx.config, x), N)
              if entry == "population" else 0.0)
        f = step.flops(entry, ctx.config, ctx.traffic, sq)
        if f is None:
            return None
        total += f
    a, b = ctx.trace["first"], ctx.trace["first"] + ctx.trace["steps"]
    rest = ctx.durations[:a] + ctx.durations[b:]
    if not rest:
        return None
    per_step = sum(rest) / len(rest)
    return 100.0 * total / len(ctx.trace["inputs"]) / peaks.FLOPS_32 / per_step
