"""Distance-scaling study: sample and sample + exact-decode throughput vs d.

Counterpart of `examples/qec_scale_study.py`. For d in 3, 5, 7, 9, 11
(rounds = d) surface-code memory at p = 1e-3:

  * detector-sampling shots/s (the fast sampler, each call fenced);
  * end to end: sample, exact decode on the device, host escalation, p_L.
    The decoder goes by regime: the tiered exact matcher (K = 6 on every
    shot, K = 12 on the heavy tail) through d = 7, the exact cluster
    decomposition (size-class DPs) from d = 9. Shots the device cannot
    certify are flagged and re-decoded whole by the native exact decoder on
    the host (`bench_qec.build_qec_workload`, at this study's fetch cap); a
    flagged count above the cap raises, since a silent undercount is not a
    result. Up to four reps are queued on the device ahead of the host
    drain.

    python -m noisyquantumsimulator_tpu_torch.studies.qec_scale_study
    python -m noisyquantumsimulator_tpu_torch.studies.qec_scale_study --ds 7 --seed 4
    python -m noisyquantumsimulator_tpu_torch.studies.qec_scale_study --small \\
        --device cpu --out /tmp/qec_scale.json

Rows of earlier runs in the output file (this study's own, never
`examples/`) are kept unless this run measures their d. Writes
`studies_out/qec_scale_study.json` (or `--out`) with the script's keys.
"""
from __future__ import annotations

import argparse
import time
from collections import deque
from typing import Optional, Sequence

import torch

from ..bench import _device
from ..bench_qec import _generator, _sync, build_qec_workload
from ..qec.exact_matcher import TieredMatcher
from ..qec.fast_sampler import build_fast_sampler
from ..qec.surface_code import memory_z_circuit
from ..utils.math import wilson_ci
from . import add_common_args, out_path, read_json, stamp, write_json

NAME = "qec_scale_study"
# decode reps per distance: cells at d <= 9 carry >= ~100 expected errors
REPS = {3: 3, 5: 3, 7: 8, 9: 26, 11: 36, 13: 36, 15: 24}
P = 1e-3


def fetch_cap(d: int, decode_shots: int) -> int:
    """Flagged rows fetched to the host a rep (d = 13 flags ~35% of shots,
    so its cap is half the rep)."""
    return decode_shots if d >= 15 else \
        min(decode_shots, max(decode_shots // (8 if d < 13 else 2), 64))


def run_point(d: int, rounds: int, p: float, sample_shots: int,
              decode_shots: int, seed: int = 0, device="cuda",
              reps: Optional[int] = None) -> dict:
    dev = torch.device(device)
    circuit = memory_z_circuit(d, rounds, p=p)
    n_det = circuit.n_detectors
    block = min(sample_shots,
                1 << 20 if d <= 7 else (1 << 18 if d <= 13 else 1 << 17))
    sampler = build_fast_sampler(circuit, block, dev)
    int(sampler(_generator(dev, 0))["detectors"].sum(dtype=torch.int64))
    n_sample = max(1, sample_shots // block) * 3
    t0 = time.perf_counter()
    tot = 0
    for r in range(n_sample):
        out = sampler(_generator(dev, r + 1))
        tot += int(out["detectors"].sum(dtype=torch.int64))
    dt_s = time.perf_counter() - t0
    shots_done = block * n_sample
    del out, sampler

    cap = fetch_cap(d, decode_shots)
    w = build_qec_workload(d, rounds, p, decode_shots, dev, cap=cap)
    if isinstance(w.decoder, TieredMatcher):
        decoder_name = ("tiered exact (K=6/K=12) + host cluster-exact "
                        "escalation of >12-defect shots")
    else:
        ks = "/".join(str(t[2]) for t in w.decoder.tiers)
        decoder_name = ("on-device exact cluster decomposition "
                        f"(K={ks} size-class DPs) + host cluster-exact "
                        "escalation of flagged shots")
    w.drain(w.e2e(_generator(dev, 100)))                       # warm-up
    _sync(dev)

    reps_d = reps or REPS.get(d, 3)
    t0 = time.perf_counter()
    errs = ovf = errs_host = 0
    pending, ri = deque(), 0
    while ri < reps_d or pending:
        while ri < reps_d and len(pending) < 4:
            # --seed shifts the whole stream, so re-runs draw fresh shots
            pending.append(w.e2e(_generator(dev, 100000 * seed + 200 + ri)))
            ri += 1
        rep = pending.popleft()
        n_all = w.drain(rep)                 # raises past the fetch cap
        n_dev, n_flag = (int(v) for v in rep.counts)
        errs += n_dev
        errs_host += n_all - n_dev
        ovf += n_flag
    _sync(dev)
    dt_d = time.perf_counter() - t0
    n_dec = decode_shots * reps_d
    n_err = errs + errs_host
    return {
        "d": d, "rounds": rounds, "p": p,
        "n_detectors": n_det,
        "detector_fraction": tot / (shots_done * n_det),
        "sample_shots_per_sec": shots_done / dt_s,
        "e2e_sample_decode_shots_per_sec": n_dec / dt_d,
        "e2e_p_logical_shot": n_err / n_dec,
        "n_errors": n_err,
        "p_L_ci95": [float(x) for x in wilson_ci(n_err, n_dec)],
        "seed": seed,
        "e2e_escalated_fraction": ovf / n_dec,
        # p_L on the escalated (host-exact) and device-decoded populations
        "p_L_on_escalated_shots": errs_host / max(ovf, 1),
        "p_L_on_device_shots": errs / max(n_dec - ovf, 1),
        "n_errors_escalated": errs_host,
        "n_errors_device": errs,
        "decoder": decoder_name,
        # per-row provenance: rows of separate runs are merged
        "backend": dev.type,
        "sample_shots": shots_done, "decode_shots": n_dec,
        "throughput_note": (
            f"study number; reps={reps_d} (the bench record's reps=3), "
            "same decode path and exactness"),
        "fetch_cap": cap,
        "wall_s": dt_s + dt_d,
    }


def run(small: bool = False, ds: Optional[Sequence[int]] = None,
        sample_shots: Optional[int] = None,
        decode_shots: Optional[int] = None, reps: Optional[int] = None,
        seed: int = 0, device="cuda",
        prev_points: Sequence[dict] = ()) -> dict:
    """Every distance's row, merged over `prev_points` (rows of the same d
    are replaced)."""
    dev = _device(device)
    ds = tuple(ds or ((3, 5) if small else (3, 5, 7, 9, 11)))
    sample_shots = sample_shots or ((1 << 16) if small else (1 << 19))
    decode_shots = decode_shots or ((1 << 14) if small else (1 << 17))
    rows = []
    print(f"{'d':>3} {'n_det':>6} {'sample shots/s':>14} {'e2e shots/s':>12} "
          f"{'p_L/shot':>10} {'errs':>5} {'escalated':>9}")
    for d in ds:
        r = run_point(d, d, P, sample_shots, decode_shots, seed=seed,
                      device=dev, reps=reps)
        rows.append(r)
        print(f"{d:>3} {r['n_detectors']:>6} {r['sample_shots_per_sec']:>14.0f} "
              f"{r['e2e_sample_decode_shots_per_sec']:>12.0f} "
              f"{r['e2e_p_logical_shot']:>10.2e} {r['n_errors']:>5} "
              f"{r['e2e_escalated_fraction']:>9.2e}", flush=True)
    merged = {r["d"]: r for r in prev_points}
    merged.update({r["d"]: r for r in rows})
    return {**stamp(dev), "points": [merged[d] for d in sorted(merged)]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="d 3, 5; 2^16 sample and 2^14 decode shots")
    ap.add_argument("--ds", default=None, help="comma-separated distances")
    ap.add_argument("--seed", type=int, default=0)
    add_common_args(ap)
    a = ap.parse_args(argv)
    path = out_path(NAME, a.out)
    ds = tuple(int(x) for x in a.ds.split(",")) if a.ds else None
    out = run(small=a.small, ds=ds, seed=a.seed, device=a.device,
              prev_points=read_json(path).get("points", []))
    print(f"wrote {write_json(path, out)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
