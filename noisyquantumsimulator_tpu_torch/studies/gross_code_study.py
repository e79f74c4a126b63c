"""The gross code [[144, 12, 12]] at two physical error rates.

Counterpart of `examples/gross_code_study.py`: p = 1e-3 and 2e-3 (seeds 11
and 12, 3 rounds) through the port's `bench.main_bb`: sample, tiered
slot-BP on the device (kernel K3 in every check-node update), damped
min-sum retry, and host OSD-0 of the non-converged residue, with the
failure check per observable. Above p = 1.5e-3 the workload takes its
non-lean budgets (8 fast iterations, retry capacity shots // 32, residue cap
shots // 16); a residue above its cap raises.

    python -m noisyquantumsimulator_tpu_torch.studies.gross_code_study
    python -m noisyquantumsimulator_tpu_torch.studies.gross_code_study --small \\
        --device cpu --out /tmp/gross.json

Writes `studies_out/gross_code_study.json` (or `--out`) with the script's
keys.
"""
from __future__ import annotations

import argparse

from ..bench import _device, main_bb
from . import add_common_args, out_path, stamp, write_json

NAME = "gross_code_study"
POINTS = ((1e-3, 11), (2e-3, 12))


def run(small: bool = False, shots: int = None, reps: int = None,
        rounds: int = 3, device="cuda") -> dict:
    """Both points at 2^16 shots x 6 reps (`small`: 2^12 x 2), or
    `shots` x `reps`."""
    dev = _device(device)
    shots = shots or ((1 << 12) if small else (1 << 16))
    reps = reps or (2 if small else 6)
    rows = {f"p={p}": main_bb(rounds=rounds, p=p, shots=shots, seed=seed,
                              reps=reps, device=dev)
            for p, seed in POINTS}
    return {**stamp(dev),
            "code": "[[144,12]]", "rounds": rounds, **rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="2^12 shots x 2 reps a point (default 2^16 x 6)")
    add_common_args(ap)
    a = ap.parse_args(argv)
    out = run(small=a.small, device=a.device)
    print(f"wrote {write_json(out_path(NAME, a.out), out)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
