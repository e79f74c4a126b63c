"""match_launches (device_trace, launches): per traced step, the kernel events
whose launch (a runtime or driver call with the same `args.correlation`)
starts inside the step's nqs.match span (`bench_qec`'s step: the tiered exact
DP's gathers, mins and selects): the host launch path's count of the
matcher."""
from nqs_bench import layer_spans, program_spans


def read(ctx):
    v, spans = layer_spans.traced(ctx, "nqs.match")
    if not spans:
        return None
    match = [(a, b) for a, b, _ in spans]
    launched = {e["args"]["correlation"] for e in v.events
                if e.get("cat") in program_spans.LAUNCH_CATS
                and "correlation" in e.get("args", {})
                and program_spans.inside(float(e["ts"]), match)}
    n = sum(1 for e in v.events if e.get("cat") == "kernel"
            and e.get("args", {}).get("correlation") in launched)
    return n / len(v.steps) if n else None
