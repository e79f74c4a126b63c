"""DEPRECATED JP-protocol optimizer shims.

Counterpart of the reference's `optimize/jp_legacy.py`, the parity module
for the deprecated `optimize_jp_protocols.py` (optimize_jp_protocols.py:25-32
module-level deprecation warning; kept entry points at :157, :279, :490,
:561, :730). Old scripts import these names; each is a thin wrapper over
the real optimizer (optimize/forward.py), so legacy call sites keep working
and actually optimize.

Every function emits a DeprecationWarning pointing at the replacement, and
takes the port's `device` / `dtype` keywords.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

warnings.warn(
    "optimize.jp_legacy is deprecated; use optimize.forward.optimize_cz_gate"
    "(protocol=...) directly.", DeprecationWarning, stacklevel=2)


def _warn(name: str, repl: str):
    warnings.warn(f"{name} is deprecated; use {repl}",
                  DeprecationWarning, stacklevel=3)


def _cost(protocol: str, params, apparatus, device, dtype, **builder_kwargs):
    from .apparatus import ApparatusConstraints
    from .engine import build_fixed_problem, make_objective
    app = apparatus or ApparatusConstraints()
    problem = build_fixed_problem(app, app.make_full_noise(), dtype=dtype,
                                  device=device)
    obj = make_objective(problem, protocol, **builder_kwargs)
    cost, _ = obj(np.asarray(params, dtype=float))
    return float(cost)


def jp_bangbang_cost(params, apparatus=None, n_segments: int = 5,
                     device="cuda", dtype: torch.dtype = torch.complex64
                     ) -> float:
    """(optimize_jp_protocols.py:157) Cost of a bang-bang parameter vector."""
    _warn("jp_bangbang_cost", "optimize.engine.make_objective")
    return _cost("jandura_pupillo", params, apparatus, device, dtype,
                 n_segments=n_segments)


def optimize_jp_bangbang(apparatus=None, n_segments: int = 5,
                         maxiter: int = 40, device="cuda",
                         dtype: torch.dtype = torch.complex64, **kw):
    """(optimize_jp_protocols.py:279) The bang-bang optimizer. It tries 5
    and 7 segments and keeps the better, so `n_segments` is accepted for
    old call sites and not passed on (optimize_cz_gate has no such
    parameter)."""
    _warn("optimize_jp_bangbang", "optimize.forward.optimize_cz_gate")
    from .forward import optimize_cz_gate
    return optimize_cz_gate("jandura_pupillo", apparatus=apparatus,
                            maxiter=maxiter, device=device, dtype=dtype, **kw)


def smooth_jp_cost(params, apparatus=None, device="cuda",
                   dtype: torch.dtype = torch.complex64) -> float:
    """(optimize_jp_protocols.py:490)"""
    _warn("smooth_jp_cost", "optimize.engine.make_objective")
    return _cost("smooth_jp", params, apparatus, device, dtype)


def optimize_smooth_jp(apparatus=None, maxiter: int = 40, device="cuda",
                       dtype: torch.dtype = torch.complex64, **kw):
    """(optimize_jp_protocols.py:561)"""
    _warn("optimize_smooth_jp", "optimize.forward.optimize_cz_gate")
    from .forward import optimize_cz_gate
    return optimize_cz_gate("smooth_jp", apparatus=apparatus,
                            maxiter=maxiter, device=device, dtype=dtype, **kw)


def evaluate_lp_baseline(apparatus=None, device="cuda",
                         dtype: torch.dtype = torch.complex128):
    """(optimize_jp_protocols.py:730)"""
    _warn("evaluate_lp_baseline", "optimize.forward.run_baseline")
    from .forward import run_baseline
    return run_baseline("lp", apparatus=apparatus, device=device, dtype=dtype)


__all__ = ["jp_bangbang_cost", "optimize_jp_bangbang", "smooth_jp_cost",
           "optimize_smooth_jp", "evaluate_lp_baseline"]
