"""NN decoder study: the pairwise-feature MLP against exact MWPM at d = 5.

Counterpart of `examples/nn_decoder_study.py`: `qec/nn_decoder.NNDecoder`
(detector bits and their pair products, hidden layers 512 and 128) trained
on the device, each step on a fresh sampler batch (`fit`), then scored
against the host native exact matcher (`NativeMatchingDecoder`, mode 0) on
the same fresh shot stream: blocks of up to 2^17 shots from
`build_fast_sampler`, block b drawn by a generator seeded 7_000_000 + b.
Counts, Wilson CIs and the trivial decoder's rate are recorded.

    python -m noisyquantumsimulator_tpu_torch.studies.nn_decoder_study --small
    python -m noisyquantumsimulator_tpu_torch.studies.nn_decoder_study \\
        --small --device cpu --out /tmp/nn.json

`--small` trains 600 steps of batch 2048 and scores 40 000 shots (default
24 000 steps of 8192, 800 000 shots). Writes
`studies_out/nn_decoder_study.json` (or `--out`) with the script's keys.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from ..bench import _device
from ..qec.dem import build_dem, dem_to_edges
from ..qec.fast_sampler import build_fast_sampler
from ..qec.native import NativeMatchingDecoder
from ..qec.nn_decoder import NNDecoder
from ..qec.surface_code import memory_z_circuit
from ..utils.math import wilson_ci
from . import add_common_args, out_path, stamp, write_json

NAME = "nn_decoder_study"
HIDDEN = (512, 128)
BLOCK = 1 << 17
SEED0 = 7_000_000


def eval_block(sampler, b: int, device):
    """Block b of the scoring stream: (detectors on `device`, observable 0
    on the host)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED0 + b)
    out = sampler(gen)
    return out["detectors"], out["observables"][:, 0].cpu().numpy() & 1


def run(small: bool = False, steps: Optional[int] = None,
        batch: Optional[int] = None, eval_shots: Optional[int] = None,
        d: int = 5, p: float = 3e-3, device="cuda") -> dict:
    """Train, then score until `eval_shots` shots (whole blocks) are done."""
    dev = _device(device)
    steps = steps or (600 if small else 24000)
    batch = batch or (2048 if small else 8192)
    eval_shots = eval_shots or (40000 if small else 800000)

    circuit = memory_z_circuit(d, d, p=p)
    dec = NNDecoder(circuit, hidden=HIDDEN, features="pairwise", seed=0,
                    device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec.fit(steps=steps, batch=batch, lr=2e-3, seed=1)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0

    edges, probs, obs_m = dem_to_edges(build_dem(circuit))
    nat = NativeMatchingDecoder(circuit.n_detectors, edges, probs, obs_m)
    sampler = build_fast_sampler(circuit, min(eval_shots, BLOCK), dev)
    err_nn = err_mwpm = err_triv = n_done = b = 0
    t0 = time.perf_counter()
    while n_done < eval_shots:
        dets, obs = eval_block(sampler, b, dev)
        pred_nn = dec.decode_batch(dets) & 1
        pred_m = nat.decode_batch_ex(dets.cpu().numpy(), mode=0)["pred"] & 1
        err_nn += int(np.sum(pred_nn != obs))
        err_mwpm += int(np.sum(pred_m != obs))
        err_triv += int(np.sum(obs))
        n_done += dets.shape[0]
        b += 1
        print(f"  block {b}: nn {err_nn}/{n_done} mwpm {err_mwpm}/{n_done}",
              flush=True)
    eval_s = time.perf_counter() - t0
    return {
        **stamp(dev),
        "d": d, "rounds": d, "p": p,
        "features": "pairwise", "hidden": list(HIDDEN),
        "train_steps": steps, "train_batch": batch,
        "train_seconds": train_s,
        "train_backend": dev.type,
        "eval_shots": n_done,
        "eval_blocks": b,
        "eval_seconds": eval_s,
        "p_logical_nn": err_nn / n_done,
        "p_logical_nn_ci95": [float(x) for x in wilson_ci(err_nn, n_done)],
        "n_errors_nn": err_nn,
        "p_logical_exact_mwpm": err_mwpm / n_done,
        "p_logical_exact_mwpm_ci95": [float(x) for x in
                                      wilson_ci(err_mwpm, n_done)],
        "n_errors_mwpm": err_mwpm,
        "p_logical_trivial": err_triv / n_done,
        "nn_over_exact_ratio": err_nn / max(err_mwpm, 1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="600 steps of 2048, 40 000 eval shots (default "
                         "24 000 of 8192, 800 000)")
    add_common_args(ap)
    a = ap.parse_args(argv)
    rec = run(small=a.small, device=a.device)
    path = write_json(out_path(NAME, a.out), rec)
    print({k: rec[k] for k in ("p_logical_nn", "p_logical_exact_mwpm",
                               "nn_over_exact_ratio", "train_seconds")})
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
