"""Decoder accuracy study: window decoding against exact matching.

Counterpart of `examples/decoder_accuracy_study.py`, at d = 7, 9, 11
(rounds = d, p = 1e-3):

  oracle     the native exact cluster decomposition of the whole shot on the
             host (`decode_batch_ex(mode=0)`; its `exact` flag certifies
             that every component was within the exact-DP budget): true
             MWPM up to ties on certified shots;
  window     the sliding-window tiered matcher on the device
             (`qec/window_matcher.WindowMatcher`, no greedy tier): windows
             over budget defer their excess defects and flag the shot;
  escalated  the window's predictions with flagged shots taken from the
             oracle (the escalating matcher's path), plus wider nets that
             also hand shots with more than T defects to the oracle.

At d <= 7 the row also splits the tiered matcher's p_L (K = 6 / K = 12,
more than 12 defects flagged) between its flagged and unflagged shots.

    python -m noisyquantumsimulator_tpu_torch.studies.decoder_accuracy_study --ds 7 --shots 524288
    python -m noisyquantumsimulator_tpu_torch.studies.decoder_accuracy_study \\
        --ds 7 --wc "5,2;7,3"
    python -m noisyquantumsimulator_tpu_torch.studies.decoder_accuracy_study \\
        --ds 3 --shots 4096 --device cpu --out /tmp/acc.json

Rows of earlier runs in the output file (this study's own, never
`examples/`) are kept unless this run measures their d. Writes
`studies_out/decoder_accuracy_study.json` (or `--out`) with the script's
keys.
"""
from __future__ import annotations

import argparse
import time
from typing import Sequence, Tuple

import numpy as np
import torch

from ..bench import _device
from ..bench_qec import K_HEAVY, _generator
from ..qec.dem import build_dem, dem_to_edges
from ..qec.exact_matcher import TieredMatcher
from ..qec.fast_sampler import build_fast_sampler
from ..qec.native import NativeMatchingDecoder
from ..qec.surface_code import memory_z_circuit, memory_z_detector_rounds
from ..qec.window_matcher import WindowMatcher
from ..utils.observability import provenance_stamp
from . import add_common_args, out_path, read_json, write_json

NAME = "decoder_accuracy_study"
P = 1e-3
ESCALATION_T = (20, 16, 12, 8)


def _decode_chunks(fn, dets: torch.Tensor, chunk: int):
    """(preds, flags) as host numpy arrays, chunk by chunk."""
    preds, flags = [], []
    for s0 in range(0, dets.shape[0], chunk):
        pw, ov = fn(dets[s0:s0 + chunk])
        preds.append(pw.cpu().numpy())
        flags.append(ov.cpu().numpy())
    return np.concatenate(preds) & 1, np.concatenate(flags).astype(bool)


def run_point(d: int, rounds: int, p: float, shots: int, block: int,
              seed0: int = 0, wcs: Sequence[Tuple[int, int]] = ((5, 2),),
              device="cuda") -> dict:
    dev = torch.device(device)
    circuit = memory_z_circuit(d, rounds, p=p)
    n_det = circuit.n_detectors
    edges, probs, obs = dem_to_edges(build_dem(circuit))
    nat = NativeMatchingDecoder(n_det, edges, probs, obs)

    chunk = min(4096, block)
    det_round = memory_z_detector_rounds(d, rounds)
    wms = {wc: WindowMatcher(n_det, edges, probs, obs, det_round,
                             window_rounds=wc[0], commit_rounds=wc[1],
                             max_defects=12, chunk=chunk, k_light=6,
                             heavy_capacity=max(chunk // 16, 64), device=dev)
           for wc in wcs}
    tiered = None
    if d <= 7:
        t_chunk = min(16384, block)
        tiered = TieredMatcher(n_det, edges, probs, obs, k_light=6,
                               k_heavy=K_HEAVY, chunk=t_chunk,
                               heavy_capacity=max(t_chunk // 16, 64),
                               device=dev)
    sampler = build_fast_sampler(circuit, block, dev)

    acc = dict(shots=0, err_oracle=0, n_cert=0, sum_ndef=0.0, t_oracle=0.0)
    wacc = {wc: dict(err_window=0, err_escalated=0, n_flagged=0,
                     err_window_flagged=0, err_window_unflagged=0,
                     err_oracle_flagged=0, t_window=0.0,
                     **{f"err_esc_T{T}": 0 for T in ESCALATION_T},
                     **{f"n_esc_T{T}": 0 for T in ESCALATION_T})
            for wc in wcs}
    tacc = dict(err=0, n_flagged=0, err_flagged=0, err_unflagged=0)
    cluster_hist = np.zeros(64, np.int64)
    ndef_hist = np.zeros(128, np.int64)

    n_blocks = (shots + block - 1) // block
    for b in range(n_blocks):
        o = sampler(_generator(dev, seed0 + 1000 + b))
        dets_dev = o["detectors"]
        dets = dets_dev.cpu().numpy()
        obs_bits = o["observables"][:, 0].cpu().numpy() & 1

        t0 = time.perf_counter()
        ro = nat.decode_batch_ex(dets, mode=0)
        acc["t_oracle"] += time.perf_counter() - t0
        pred_o = ro["pred"] & 1
        acc["err_oracle"] += int(np.sum(pred_o != obs_bits))
        acc["n_cert"] += int(ro["exact"].sum())
        acc["sum_ndef"] += float(ro["n_defects"].sum())
        cluster_hist += np.bincount(np.clip(ro["max_cluster"], 0, 63),
                                    minlength=64)
        ndef_hist += np.bincount(np.clip(ro["n_defects"], 0, 127),
                                 minlength=128)

        for wc, wm in wms.items():
            a = wacc[wc]
            t0 = time.perf_counter()
            pred_w, ovf = _decode_chunks(wm.decode_device_with_overflow,
                                         dets_dev, chunk)
            a["t_window"] += time.perf_counter() - t0
            wrong = pred_w != obs_bits
            a["err_window"] += int(wrong.sum())
            a["n_flagged"] += int(ovf.sum())
            a["err_window_flagged"] += int(np.sum(wrong & ovf))
            a["err_window_unflagged"] += int(np.sum(wrong & ~ovf))
            a["err_oracle_flagged"] += int(np.sum((pred_o != obs_bits) & ovf))
            a["err_escalated"] += int(np.sum(
                np.where(ovf, pred_o, pred_w) != obs_bits))
            # wider escalation nets: also hand shots with more than T
            # defects to the oracle
            for T in ESCALATION_T:
                esc = ovf | (ro["n_defects"] > T)
                a[f"err_esc_T{T}"] += int(np.sum(
                    np.where(esc, pred_o, pred_w) != obs_bits))
                a[f"n_esc_T{T}"] += int(esc.sum())

        if tiered is not None:
            pred_t, flag_t = _decode_chunks(
                lambda c: (tiered.decode_device(c),
                           c.to(torch.int32).sum(dim=1) > K_HEAVY),
                dets_dev, tiered.chunk)
            wrong = pred_t != obs_bits
            tacc["err"] += int(wrong.sum())
            tacc["n_flagged"] += int(flag_t.sum())
            tacc["err_flagged"] += int(np.sum(wrong & flag_t))
            tacc["err_unflagged"] += int(np.sum(wrong & ~flag_t))
        acc["shots"] += block
        a0 = wacc[wcs[0]]
        print(f"  d={d} block {b + 1}/{n_blocks}: oracle p_L "
              f"{acc['err_oracle'] / acc['shots']:.3e}, "
              f"W{wcs[0][0]}C{wcs[0][1]} window "
              f"{a0['err_window'] / acc['shots']:.3e}, escalated "
              f"{a0['err_escalated'] / acc['shots']:.3e}, flagged "
              f"{a0['n_flagged'] / acc['shots']:.3e}", flush=True)

    S = acc["shots"]
    row = {
        "d": d, "rounds": rounds, "p": p, "shots": S,
        "n_detectors": n_det,
        "mean_defects": acc["sum_ndef"] / S,
        "p_L_oracle": acc["err_oracle"] / S,
        "oracle_certified_fraction": acc["n_cert"] / S,
        "max_cluster_hist": {str(i): int(v)
                             for i, v in enumerate(cluster_hist) if v},
        "n_defects_p99": int(np.searchsorted(np.cumsum(ndef_hist), 0.99 * S)),
        "oracle_shots_per_sec_host": S / max(acc["t_oracle"], 1e-9),
        "windows": {},
        "n_errors_oracle": acc["err_oracle"],
    }
    for wc in wcs:
        a = wacc[wc]
        nf = max(a["n_flagged"], 1)
        row["windows"][f"W{wc[0]}C{wc[1]}"] = {
            "p_L_window": a["err_window"] / S,
            "p_L_escalated": a["err_escalated"] / S,
            "flagged_fraction": a["n_flagged"] / S,
            "p_L_window_given_flagged": a["err_window_flagged"] / nf,
            "p_L_oracle_given_flagged": a["err_oracle_flagged"] / nf,
            "p_L_window_unflagged_shots":
                a["err_window_unflagged"] / max(S - a["n_flagged"], 1),
            **{f"p_L_esc_T{T}": a[f"err_esc_T{T}"] / S for T in ESCALATION_T},
            **{f"esc_frac_T{T}": a[f"n_esc_T{T}"] / S for T in ESCALATION_T},
            "n_errors_window": a["err_window"],
            "n_errors_escalated": a["err_escalated"],
            "window_shots_per_sec": S / max(a["t_window"], 1e-9),
        }
    if tiered is not None:
        nf = tacc["n_flagged"]
        row["tiered_overflow_split"] = {
            "p_L_tiered": tacc["err"] / S,
            "overflow_fraction": nf / S,
            "p_L_on_overflow_shots": tacc["err_flagged"] / max(nf, 1),
            "p_L_on_non_overflow_shots":
                tacc["err_unflagged"] / max(S - nf, 1),
        }
    return row


def run(ds: Sequence[int] = (7, 9, 11), shots: int = 1 << 20,
        wcs: Sequence[Tuple[int, int]] = ((5, 2),), device="cuda", prev_points: Sequence[dict] = ()) -> dict:
    """Every distance's row in blocks of up to 2^17 shots, merged over
    `prev_points` (rows of the same d are replaced)."""
    dev = _device(device)
    block = min(shots, 1 << 17)
    rows = []
    for d in ds:
        print(f"d={d} rounds={d} p={P} shots={shots} wcs={tuple(wcs)}",
              flush=True)
        rows.append(run_point(d, d, P, shots, block, wcs=tuple(wcs),
                              device=dev))
    merged = {r["d"]: r for r in prev_points}
    merged.update({r["d"]: r for r in rows})
    return {"p": P, **provenance_stamp(),
            "points": [merged[k] for k in sorted(merged)]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ds", default="7,9,11", help="comma-separated distances")
    ap.add_argument("--shots", type=int, default=1 << 20)
    ap.add_argument("--wc", default="5,2",
                    help='window,commit pairs separated by ";" (e.g. "5,2;7,3")')
    add_common_args(ap)
    a = ap.parse_args(argv)
    path = out_path(NAME, a.out)
    wcs = tuple(tuple(int(v) for v in pair.split(","))
                for pair in a.wc.split(";"))
    out = run(ds=tuple(int(x) for x in a.ds.split(",")), shots=a.shots,
              wcs=wcs, device=a.device,
              prev_points=read_json(path).get("points", []))
    print(f"wrote {write_json(path, out)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
