#!/usr/bin/env python3
"""Where the time of one MS-gate simulation goes on the card.

    python3 tools/ms_gate_breakdown.py

Run from the root of the repository on an NVIDIA GPU. After a warm-up, one
`simulate_ms_gate(n_fock=10)` call at the yb171_default regime (the shipped
record's; 7 noise cases, 19 expms of (1600, 1600) complex128) runs under
cProfile: the host seconds of the Liouvillian builds (`build_ms_system`,
`hamiltonian_superop`, `dissipator_superop`), of the device channel
(`qubit_channel_device`: the host 1-norm, the copy to the card, the expm,
the projection and the copy back) and of the rest, with the 12 functions of
most own time. Then one call under torch.profiler: the device's busy and
idle share of the call and its time by kernel family (K2, cuBLAS products,
the LU solve, copies, the rest). Last, the card's name and power limit.
"""
from __future__ import annotations

import cProfile
import pstats
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from noisyquantumsimulator_tpu_torch.bench import card  # noqa: E402
from noisyquantumsimulator_tpu_torch.studies.ms_gate_engine_study import (  # noqa: E402
    REGIMES)
from noisyquantumsimulator_tpu_torch.utils.profiling import profile_window  # noqa: E402

FAMILIES = (("K2", ("masked_square",)),
            ("cuBLAS products", ("gemm", "xmma", "cutlass", "cublas")),
            ("LU solve", ("getrf", "getrs", "trsm", "laswp", "lu", "pivot")),
            ("copies", ("memcpy", "Memcpy", "memset", "Memset")))


def main() -> int:
    import torch
    from noisyquantumsimulator_tpu_torch.gate import ms_gate
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    kw = REGIMES["yb171_default"]
    run = lambda: ms_gate.simulate_ms_gate(n_fock=10, **kw)
    run()
    torch.cuda.synchronize()

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    run()
    torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t0
    st = pstats.Stats(prof)
    cum = {f[2]: v[3] for f, v in st.stats.items()}
    print(f"[ms breakdown] one simulate_ms_gate(n_fock=10) [yb171_default]: "
          f"{wall:.3f} s under cProfile", flush=True)
    for name in ("liouvillian_stack", "build_ms_system", "hamiltonian_superop",
                 "dissipator_superop", "qubit_channel_device", "expm",
                 "probe_basis", "twirled_error_probs", "is_cptp"):
        print(f"[ms breakdown]   {name}: {cum.get(name, 0.0):.3f} s cumulative",
              flush=True)
    st.sort_stats("tottime")
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:12]
    for (fn, line, name), (_, ncalls, tt, ct, _) in rows:
        print(f"[ms breakdown]   own {tt:.3f} s, cumulative {ct:.3f} s, "
              f"{ncalls} calls: {name} ({Path(fn).name}:{line})", flush=True)

    wall, idle, by_name, path, _ = profile_window(run, "ms_gate", n_calls=1)
    if idle is None:
        print(f"[ms breakdown] profiler: no device events in {path}", flush=True)
    else:
        total = sum(by_name.values())
        print(f"[ms breakdown] torch.profiler, one call: wall {wall:.3f} s, device "
              f"time {total / 1e6:.3f} s summed over kernels and copies, idle share "
              f"of the device span {idle:.4f} (trace {path})", flush=True)
        left = dict(by_name)
        for fam, needles in FAMILIES:
            t = sum(v for k, v in by_name.items() if any(n in k for n in needles))
            for k in [k for k in left if any(n in k for n in needles)]:
                del left[k]
            print(f"[ms breakdown]   {fam}: {t / 1e3:.3f} ms ({t / total * 100:.1f}%)",
                  flush=True)
        rest = sum(left.values())
        print(f"[ms breakdown]   the rest: {rest / 1e3:.3f} ms "
              f"({rest / total * 100:.1f}%); largest: " + "; ".join(
                  f"{k[:50]} {v / 1e3:.3f} ms" for k, v in
                  sorted(left.items(), key=lambda kv: -kv[1])[:3]), flush=True)
    print(*card(), sep=", ", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
