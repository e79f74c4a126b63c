"""The program's own spans (`noisyquantumsimulator_tpu_torch.utils.observability`:
nqs.plan, nqs.step, nqs.scan) set against a traced run's chrome trace.

The spans are stamped with `time.time_ns()`, the trace's clock: an event
starts at its `ts` (us) x 1e3 plus the file's `baseTimeNanoseconds`. The
traced steps are the nqs.step spans that overlap the trace's events; there
must be as many as the run traced. A program without the recorder keeps no
spans, and the readers then read nothing."""
from __future__ import annotations

import json
from types import SimpleNamespace
from typing import List, Optional, Tuple

from nqs_bench import tracing

PLAN, STEP, SCAN = "nqs.plan", "nqs.step", "nqs.scan"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def recorded() -> Optional[list]:
    """The program's span records, or None if it keeps none."""
    from noisyquantumsimulator_tpu_torch.utils import observability
    spans = getattr(observability, "spans", None)
    return None if spans is None else spans()


def base_ns(path: str) -> int:
    """The trace file's `baseTimeNanoseconds` (`tracing.load_events` drops it)."""
    with open(path) as f:
        return int(json.load(f)["baseTimeNanoseconds"])


def view(ctx) -> Optional[SimpleNamespace]:
    """records (all, in order); steps and scans: (start us, end us) on the
    trace's clock of the traced nqs.step spans and of their nqs.scan spans;
    events: the trace's complete events. None for an untraced run or a
    program without spans."""
    if ctx.trace is None:
        return None
    records = recorded()
    if records is None:
        return None
    base = base_ns(ctx.trace["path"])
    evs = [e for e in ctx.trace["events"] if e.get("ph") == "X"]
    lo = min(float(e["ts"]) for e in evs)
    hi = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in evs)

    def us(r):
        return (r.start_ns - base) * 1e-3, (r.end_ns - base) * 1e-3

    ids = [i for i, r in enumerate(records) if r.name == STEP and r.end_ns is not None
           and us(r)[0] < hi and us(r)[1] > lo]
    if len(ids) != ctx.trace["steps"]:
        raise RuntimeError(f"{len(ids)} program {STEP} spans in the traced window, "
                           f"{ctx.trace['steps']} steps traced")
    scans = [us(r) for r in records if r.name == SCAN and r.step in ids]
    return SimpleNamespace(records=records, steps=[us(records[i]) for i in ids],
                           scans=scans, events=evs)


def first(v, name: str):
    """The first record named `name`."""
    for r in v.records:
        if r.name == name:
            return r
    raise RuntimeError(f"the program recorded no {name} span")


def seconds(r) -> float:
    return (r.end_ns - r.start_ns) * 1e-9


def inside(t: float, spans) -> bool:
    return any(a <= t <= b for a, b in spans)


def scan_device(v) -> List[Tuple[float, float]]:
    """The union (us) of the device intervals whose launch (a runtime or
    driver call with the same `args.correlation`) starts inside one of the
    traced steps' scans."""
    launched = {e["args"]["correlation"] for e in v.events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})
                and inside(float(e["ts"]), v.scans)}
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                 for e in v.events if e.get("cat") in tracing.DEVICE_CATS
                 and e.get("args", {}).get("correlation") in launched)
    return tracing.merged(dev)


def program_idle_us(v, dev) -> float:
    """Idle time (us) between the device intervals `dev` whose gap begins
    while the host is inside a traced step."""
    u = tracing.merged(dev)
    return sum(b - a for (_, a), (b, _) in zip(u, u[1:]) if inside(a, v.steps))
