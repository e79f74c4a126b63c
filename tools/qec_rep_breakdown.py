#!/usr/bin/env python3
"""Where the time of one surface-code end-to-end rep goes on the card.

    python3 tools/qec_rep_breakdown.py

Run from the root of the repository on an NVIDIA GPU. For the qec_d7 and
qec_d9 workloads of bench_qec (131072 shots a rep), after a warm-up:

  - the device time of each stage, CUDA events around the stage, median of
    5: the sampler; the device decode (at d = 7 split into the K = 6 DP over
    every chunk and the K = 12 DP on the heavy rows; at d = 9 the cluster
    decomposition); finalize (scores, compaction, copies to pinned memory);
  - the host time of the drain (the native re-decode of the flagged rows);
  - one rep under torch.profiler: device kernels launched, the device's busy
    time and idle share, time by kernel family (cuBLAS products, gathers and
    scatters, sorts, elementwise, reductions, copies);
  - the host wall time of one rep, queued and drained alone.

Last, the card's name and power limit.
"""
from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from noisyquantumsimulator_tpu_torch.bench import card  # noqa: E402

FAMILIES = (("cuBLAS products", ("gemm", "xmma", "cutlass", "cublas")),
            ("gathers / scatters", ("gather", "scatter", "index")),
            ("sorts", ("sort", "radix")),
            ("reductions", ("reduce",)),
            ("elementwise", ("elementwise",)),
            ("copies", ("memcpy", "memset", "copy")))


def _events_ms(fn, reps=5):
    import torch
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _gen(seed):
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


def breakdown(d: int) -> dict:
    import torch
    from noisyquantumsimulator_tpu_torch import bench_qec
    from noisyquantumsimulator_tpu_torch.qec.decoders import stable_top_rows
    from noisyquantumsimulator_tpu_torch.qec.exact_matcher import TieredMatcher
    w = bench_qec.build_qec_workload(d=d, rounds=d, p=1e-3, device="cuda")
    dec = w.decoder
    w.drain(w.e2e(_gen(1)))
    torch.cuda.synchronize()
    out = {"d": d, "shots_a_rep": w.decode_shots, "chunk": w.chunk}
    o = w.sampler(_gen(2))
    dets = o["detectors"]
    out["sample_ms"] = _events_ms(lambda: w.sampler(_gen(3)))
    out["decode_ms"] = _events_ms(
        lambda: bench_qec.device_decode(dec, dets, w.chunk))
    if isinstance(dec, TieredMatcher):
        chunks = [dets[s:s + w.chunk] for s in range(0, len(dets), w.chunk)]
        out["decode_light_ms"] = _events_ms(
            lambda: [dec.light.decode_device(c) for c in chunks])
        heavy = [c.index_select(0, stable_top_rows(
            c.to(torch.int32).sum(dim=1), dec.heavy_capacity)) for c in chunks]
        out["decode_heavy_ms"] = _events_ms(
            lambda: [dec.heavy.decode_device(h) for h in heavy])
    preds, flags = bench_qec.device_decode(dec, dets, w.chunk)
    obs = o["observables"][:, 0].to(torch.int32)

    def finalize():
        err = (preds ^ obs) & 1
        idx = stable_top_rows(flags, w.cap)
        counts = torch.stack([torch.where(flags, 0, err).sum(), flags.sum()])
        return [bench_qec._to_host(t) for t in
                (counts, dets[idx], obs[idx], flags[idx])]
    out["finalize_ms"] = _events_ms(finalize)
    reps = [w.e2e(_gen(10 + r)) for r in range(5)]
    for r in reps:
        r.done.synchronize()
    host = []
    for r in reps:
        t0 = time.perf_counter()
        w.drain(r)
        host.append(time.perf_counter() - t0)
    out["drain_host_ms"] = statistics.median(host) * 1e3
    out["flagged_a_rep"] = statistics.median(int(r.counts[1]) for r in reps)
    t0 = time.perf_counter()
    w.drain(w.e2e(_gen(20)))
    torch.cuda.synchronize()
    out["rep_wall_ms"] = (time.perf_counter() - t0) * 1e3

    idle, top, path = bench_qec.device_profile(
        lambda: w.drain(w.e2e(_gen(21))), f"qec_d{d}_breakdown")
    with open(path) as f:
        evs = json.load(f)
    evs = evs["traceEvents"] if isinstance(evs, dict) else evs
    kern = [e for e in evs if e.get("ph") == "X" and e.get("cat") in
            ("kernel", "gpu_memcpy", "gpu_memset")]
    busy = sum(float(e.get("dur", 0.0)) for e in kern)
    fam = {name: 0.0 for name, _ in FAMILIES}
    fam["other"] = 0.0
    for e in kern:
        n = e.get("name", "").lower()
        key = next((name for name, needles in FAMILIES
                    if any(s in n for s in needles)), "other")
        fam[key] += float(e.get("dur", 0.0))
    out["device_events_a_rep"] = len(kern)
    out["device_busy_ms"] = busy / 1e3
    out["idle_share"] = idle
    out["by_family_share"] = {k: round(v / busy, 4) for k, v in fam.items()}
    out["top_kernels_us"] = [[n[:60], round(t, 1)] for n, t in top]
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    for d in (7, 9):
        print(json.dumps(breakdown(d)), flush=True)
    print(*card(), sep=", ", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
