"""The traced steps' spans of one name (`program_spans.view`'s records, on the
trace's clock), for the readers of a layer inside the step: the host's time
in them, the count they carry, and the device work launched from them. A
program that records no such span gives nothing to read."""
from __future__ import annotations

from types import SimpleNamespace
from typing import List, Optional, Tuple

from nqs_bench import program_spans


def traced(ctx, name: str) -> Tuple[Optional[SimpleNamespace], List[tuple]]:
    """(the view, [(start us, end us, record)] of the `name` spans that
    start inside a traced step), or (None, []) where nothing is traced."""
    v = program_spans.view(ctx)
    if v is None:
        return None, []
    base = program_spans.base_ns(ctx.trace["path"])
    out = []
    for r in v.records:
        if r.name == name and r.end_ns is not None:
            a, b = (r.start_ns - base) * 1e-3, (r.end_ns - base) * 1e-3
            if program_spans.inside(a, v.steps):
                out.append((a, b, r))
    return v, out


def host_ms(ctx, name: str) -> Optional[float]:
    """The host's time inside the `name` spans, ms a traced step."""
    v, spans = traced(ctx, name)
    return 1e-3 * sum(b - a for a, b, _ in spans) / len(v.steps) if spans else None


def count(ctx, name: str) -> Optional[float]:
    """The counts the `name` spans carry, a traced step; None where a span
    carries none."""
    v, spans = traced(ctx, name)
    if not spans or any(getattr(r, "count", None) is None for *_, r in spans):
        return None
    return sum(r.count for *_, r in spans) / len(v.steps)


def device_ms(ctx, name: str) -> Optional[float]:
    """The union of the device intervals launched from inside the `name`
    spans (matched by `args.correlation`), ms a traced step."""
    v, spans = traced(ctx, name)
    if not spans:
        return None
    inner = SimpleNamespace(events=v.events, scans=[(a, b) for a, b, _ in spans])
    return 1e-3 * sum(b - a for a, b in program_spans.scan_device(inner)) / len(v.steps)
