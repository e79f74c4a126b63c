"""What the benchmark reads from a profiler trace (torch.profiler, chrome
format): device intervals, the device's busy and idle time, the top device
operations and the longest idle gaps, named by what the host was doing
where the trace recorded the host's ops.

The idle share is the arithmetic of the program's
`utils/profiling.profile_window`, copied: 1 - union of kernel, memcpy and
memset intervals / their span."""
from __future__ import annotations

import heapq
import json
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


def load_events(path: str) -> List[dict]:
    with open(path) as f:
        evs = json.load(f)
    return evs["traceEvents"] if isinstance(evs, dict) else evs


def _complete(evs, cats):
    return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                   e.get("name", ""), e.get("cat"))
                  for e in evs if e.get("ph") == "X" and e.get("cat") in cats)


def device_events(evs) -> List[Tuple[float, float, str, str]]:
    """(start us, end us, name, category) of every device activity."""
    return _complete(evs, DEVICE_CATS)


def kernels(dev, needle: str = "") -> List[Tuple[float, float, str, str]]:
    """The kernels among `dev` whose name holds `needle`."""
    return [d for d in dev if d[3] == "kernel" and needle in d[2]]


def merged(dev) -> List[Tuple[float, float]]:
    """The union of the intervals of `dev` as disjoint sorted intervals."""
    out: List[List[float]] = []
    for a, b, *_ in dev:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_span(dev) -> Tuple[float, float]:
    """(busy us, span us): the union's length and first start to last end."""
    u = merged(dev)
    if not u:
        return 0.0, 0.0
    return sum(b - a for a, b in u), u[-1][1] - u[0][0]


def idle_share(dev):
    """1 - busy / span of the device intervals, or None without any."""
    busy, span = busy_span(dev)
    return None if span <= 0 else 1.0 - busy / span


def top_device_ops(dev, k: int = 10) -> List[list]:
    """[name, seconds] of the k device operations that took most time."""
    tot: Dict[str, float] = {}
    for a, b, name, _ in dev:
        tot[name] = tot.get(name, 0.0) + (b - a)
    return [[n, t * 1e-6] for n, t in sorted(tot.items(), key=lambda x: -x[1])[:k]]


def idle_gaps(evs, dev, k: int = 10) -> List[list]:
    """[name, seconds] of the idle gaps between device intervals, summed by
    name, the k largest. A gap is named by the innermost host op (or
    annotation) running at its start; in a trace that recorded no host ops,
    by the device operation it follows ("after <op>")."""
    host = _complete(evs, HOST_CATS)
    if not host:
        return _gaps_after(dev, k)
    u = merged(dev)
    tot: Dict[str, float] = {}
    active: list = []          # (duration, end, name), the shortest on top
    i = 0
    for (_, end), (nxt, _) in zip(u, u[1:]):
        while i < len(host) and host[i][0] <= end:
            a, b, name, _ = host[i]
            heapq.heappush(active, (b - a, b, name))
            i += 1
        while active and active[0][1] < end:
            heapq.heappop(active)
        name = active[0][2] if active else "(no host op)"
        tot[name] = tot.get(name, 0.0) + (nxt - end)
    return [[n, t * 1e-6] for n, t in sorted(tot.items(), key=lambda x: -x[1])[:k]]


def _gaps_after(dev, k: int) -> List[list]:
    """The idle gaps named by the device operation that ends last before
    each, summed by name, the k largest."""
    tot: Dict[str, float] = {}
    end, name = None, ""
    for a, b, n, _ in dev:
        if end is not None and a > end:
            key = f"after {name}"
            tot[key] = tot.get(key, 0.0) + (a - end)
        if end is None or b >= end:
            end, name = b, n
    return [[n, t * 1e-6] for n, t in sorted(tot.items(), key=lambda x: -x[1])[:k]]
