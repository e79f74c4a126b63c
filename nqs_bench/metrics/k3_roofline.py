"""k3_roofline (device_trace, %): K3's bound over a BB step's bytes
(`roofline/k3.py`: both tiers' launches at their shapes, at the bandwidth of
`peaks.py`) over the traced device time of the `c2v_kernel` launches a
step. None where no K3 launch was traced."""
from nqs_bench import peaks, tracing
from nqs_bench.roofline import k3

KERNEL = "c2v_kernel"


def read(ctx):
    if ctx.trace is None or "dem" not in ctx.config:
        return None
    ev = tracing.kernels(ctx.trace["device"], KERNEL)
    if not ev:
        return None
    t = sum(b - a for a, b, *_ in ev) * 1e-6 / ctx.trace["steps"]
    bound = peaks.bound_s(0.0, k3.step_bytes(ctx.config, int(ctx.traffic["shots"])))
    return 100.0 * bound / t
