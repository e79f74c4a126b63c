"""The device's busy and idle time over a window of calls (torch.profiler).

Used by the bench records, `chip_smoke.py` and the tools under `tools/`.
The chrome trace of each window goes to `_build/traces/<tag>_trace.json`
(git-ignored).
"""
from __future__ import annotations

import json
import os
import time

TRACE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "_build", "traces")


def profile_window(fn, tag: str, n_calls: int = 3, host_ops: bool = True):
    """torch.profiler over `n_calls` calls of fn after one warm-up call.

    Returns (wall seconds per call, the device's idle share within the
    kernels' span = 1 - union of kernel, memcpy and memset intervals / span,
    {kernel name: device microseconds}, trace path, number of device
    events); the idle share and the dict are None when the trace holds no
    device events. host_ops=False records the device activity alone (no
    host op events): for a call of hundreds of thousands of small ops,
    whose full trace would be several times larger."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n_calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n_calls
    os.makedirs(TRACE_DIR, exist_ok=True)
    path = os.path.join(TRACE_DIR, f"{tag}_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        evs = json.load(f)
    evs = evs["traceEvents"] if isinstance(evs, dict) else evs
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                  e.get("name", "")) for e in evs
                 if e.get("ph") == "X" and e.get("cat") in
                 ("kernel", "gpu_memcpy", "gpu_memset"))
    if not dev:
        return wall, None, None, path, 0
    busy, end = 0.0, dev[0][0]
    by_name = {}
    for a, b, name in dev:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    return wall, 1.0 - busy / (end - dev[0][0]), by_name, path, len(dev)


__all__ = ["profile_window", "TRACE_DIR"]
