"""GRAPE-style optimal control: all 300 segment phases as free parameters.

Counterpart of `examples/grape_optimal_control.py`. Start from the
literature smooth-JP pulse, release every per-segment phase, and descend the
DE optimizer's cost (noisy physics, full Lindblad) with Adam (`grape_adam`,
optax.adam's update) on the gradient of `make_value_and_grad(problem,
"grape")`, which runs kernel K2 as an autograd Function on the card. The
cost is read on the host only at the logged iterations.

    python -m noisyquantumsimulator_tpu_torch.studies.grape_optimal_control
    python -m noisyquantumsimulator_tpu_torch.studies.grape_optimal_control \\
        --n-steps 48 --iters 20 --device cpu --out /tmp/grape.json

Writes `studies_out/grape_optimal_control.json` (or `--out`) with the
script's keys; `backend` is the device type, `device` and `power_limit`
name the card.
"""
from __future__ import annotations

import argparse
import time
import warnings

import torch

from ..bench import _device, card
from ..optimize.apparatus import ApparatusConstraints
from ..optimize.engine import (build_fixed_problem, make_objective,
                               make_value_and_grad,
                               smooth_jp_uniform_from_params)
from ..optimize.forward import get_smooth_jp_bounds_and_x0, grape_adam
from ..solver.propagator import real_dtype
from ..utils.observability import provenance_stamp
from . import add_common_args, out_path, write_json

NAME = "grape_optimal_control"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(n_steps: int = 300, iters: int = 400, lr: float = 2e-3,
        device="cuda", dtype: torch.dtype = torch.complex64,
        log_every: int = 50) -> dict:
    """The study at complex `dtype` (complex64 as the reference's 32-bit
    run; complex128 for parity checks). The cost is logged at every
    `log_every`-th iteration and the last."""
    dev = _device(device)
    app = ApparatusConstraints()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        problem = build_fixed_problem(app, app.make_full_noise(), dtype=dtype,
                                      device=dev)

    # baseline: the literature smooth-JP ansatz evaluated by the same core
    _, x0 = get_smooth_jp_bounds_and_x0()
    cost0, m0 = make_objective(problem, "smooth_jp", n_steps=n_steps)(x0)
    f0 = float(m0["avg_fidelity"])

    phases0, _, _ = smooth_jp_uniform_from_params(torch.as_tensor(x0), problem,
                                                  n_steps=n_steps)
    kw = dict(omega_tau=float(x0[0]), delta_over_omega=float(x0[4]))
    vg = make_value_and_grad(problem, "grape", **kw)
    obj = make_objective(problem, "grape", **kw)

    phases = phases0.to(device=dev, dtype=real_dtype(dtype)).clone()
    phases.requires_grad_(True)
    opt = grape_adam(phases, lr)
    _sync(dev)
    t0 = time.perf_counter()
    hist = []
    for it in range(iters):
        cost, grad = vg(phases.detach())
        phases.grad = grad
        opt.step()
        if it % log_every == 0 or it == iters - 1:
            hist.append({"iter": it, "cost": float(cost)})
            print(f"iter {it:4d}  cost {float(cost):10.4f}", flush=True)
    _sync(dev)
    dt = time.perf_counter() - t0

    cost1, m1 = obj(phases.detach())
    f1 = float(m1["avg_fidelity"])
    name, limit = card() if dev.type == "cuda" else ("cpu", None)
    out = {
        "backend": dev.type, "device": name, "power_limit": limit,
        "n_steps": n_steps, "iters": iters, "lr": lr,
        "baseline_smooth_jp": {"cost": float(cost0), "avg_fidelity": f0},
        "grape": {"cost": float(cost1), "avg_fidelity": f1,
                  "controlled_phase_deg": float(m1["controlled_phase_deg"]),
                  "gate_time_us": float(m1["gate_time_us"])},
        "seconds": dt, "history": hist,
        "grad_dim": n_steps,
        "dtype": str(dtype).replace("torch.", ""),
    }
    print(f"smooth-JP ansatz: F={f0:.6f} cost={float(cost0):.3f}")
    print(f"GRAPE ({n_steps} free phases, {iters} adam steps, {dt:.1f}s): "
          f"F={f1:.6f} cost={float(cost1):.3f}")
    return {**out, **{k: v for k, v in provenance_stamp().items()
                      if k not in out}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-steps", type=int, default=300)
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--lr", type=float, default=2e-3)
    add_common_args(ap)
    a = ap.parse_args(argv)
    out = run(n_steps=a.n_steps, iters=a.iters, lr=a.lr, device=a.device)
    print(f"wrote {write_json(out_path(NAME, a.out), out)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
