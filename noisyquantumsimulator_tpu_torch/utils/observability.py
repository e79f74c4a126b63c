"""Structured metrics, timers, and profiler hooks.

The reference has only ad-hoc verbose prints and wall-clock fields
(SURVEY.md 5: simulation.py:2994, optimize_cz_gate.py:1059). This module
provides the structured replacement: hierarchical timers, a metrics
registry with JSONL export, and torch.profiler integration for device
traces.

Counterpart of the reference's `utils/observability.py`. `MetricsRegistry`
is copied; `profile_trace` and `annotate` use torch.profiler where the
reference uses jax.profiler; `provenance_stamp` and `device_memory_stats`
read torch's devices. The reference's `log_compile_time` times XLA's
lowering and compile of a jitted function: the port compiles nothing of that
kind, so it has no counterpart.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from .profiling import TRACE_DIR


@dataclass
class MetricsRegistry:
    """Counter/gauge/timer store with JSONL export."""
    counters: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    gauges: Dict[str, float] = field(default_factory=dict)
    timings: Dict[str, List[float]] = field(default_factory=lambda: defaultdict(list))
    events: List[Dict] = field(default_factory=list)

    def incr(self, name: str, value: float = 1.0):
        self.counters[name] += value

    def gauge(self, name: str, value: float):
        self.gauges[name] = float(value)

    def record(self, name: str, seconds: float):
        self.timings[name].append(float(seconds))

    def event(self, name: str, **fields):
        self.events.append({"event": name, "t": time.time(), **fields})

    @contextlib.contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def summary(self) -> Dict[str, Any]:
        timing_stats = {
            k: {"n": len(v), "total_s": sum(v),
                "mean_s": sum(v) / len(v) if v else 0.0,
                "max_s": max(v) if v else 0.0}
            for k, v in self.timings.items()}
        return {"counters": dict(self.counters), "gauges": dict(self.gauges),
                "timings": timing_stats, "n_events": len(self.events)}

    def dump_jsonl(self, path: str):
        with open(path, "a") as f:
            f.write(json.dumps({"summary": self.summary(),
                                "t": time.time()}) + "\n")
            for e in self.events:
                f.write(json.dumps(e) + "\n")

    def reset(self):
        self.counters.clear()
        self.gauges.clear()
        self.timings.clear()
        self.events.clear()


# global default registry (opt-in; engine code does not auto-register)
metrics = MetricsRegistry()


@contextlib.contextmanager
def profile_trace(logdir: Optional[str] = None, name: str = "trace"):
    """torch.profiler over the block (the host, and the card when torch sees
    one); the chrome trace goes to `<logdir>/<name>.json` (default logdir:
    the port's `_build/traces`). View it with Perfetto or chrome://tracing.
    Yields the trace path."""
    from torch.profiler import ProfilerActivity, profile
    logdir = logdir or TRACE_DIR
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"{name}.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def annotate(name: str):
    """Named region visible in profiler traces (record_function)."""
    with torch.profiler.record_function(name):
        yield


def provenance_stamp() -> Dict[str, str]:
    """`{generated_at_commit, engine, backend}` for study/bench JSON
    artifacts, so a stale artifact is detectable by commit instead of
    silently contradicting newer records. `backend` is "cuda" when torch
    sees a card, else "cpu"; `device` names the card."""
    import subprocess
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        commit = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
            cwd=repo).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        commit = "unknown"
    cuda = torch.cuda.is_available()
    return {"generated_at_commit": commit,
            "backend": "cuda" if cuda else "cpu",
            "device": torch.cuda.get_device_name(0) if cuda else "cpu",
            "generated_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                          time.gmtime())}


def device_memory_stats() -> Dict[str, Any]:
    """Per-device memory stats: `torch.cuda.memory_stats` of every card
    torch sees; {"cpu": None} when it sees none (torch keeps no CPU
    allocator statistics)."""
    if not torch.cuda.is_available():
        return {"cpu": None}
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}


__all__ = ["MetricsRegistry", "metrics", "profile_trace", "annotate",
           "device_memory_stats", "provenance_stamp"]
