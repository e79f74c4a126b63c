"""The PyTorch port's host plan against the JAX reference, plus the port's
package hygiene (no JAX at import, no build at import, TF32 off).

The plan is host numpy in both packages; `jnp` and `np` transcendentals may
differ in the last ulp, hence relative 1e-12 rather than bit equality. The
squaring bound is an integer and must be equal.
"""
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from noisyquantumsimulator_tpu.core import configs as jcfg
from noisyquantumsimulator_tpu.gate import simulate as jsim
from noisyquantumsimulator_tpu_torch.core import configs as tcfg
from noisyquantumsimulator_tpu_torch.gate import simulate as tsim

torch.set_num_threads(1)

PROTOCOLS = {
    "smooth_jp": lambda c: c.SmoothJPSimulationInputs(),
    "lp_square": lambda c: c.LPSimulationInputs(pulse_shape="square"),
    "bangbang": lambda c: c.JPSimulationInputs(),
}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _plans(protocol, dim):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jp = jsim.plan_cz_gate(PROTOCOLS[protocol](jcfg), hilbert_space_dim=dim,
                               n_steps_smooth=60)
        tp = tsim.plan_cz_gate(PROTOCOLS[protocol](tcfg), hilbert_space_dim=dim,
                               n_steps_smooth=60)
    return jp, tp


@pytest.mark.parametrize("dim", [3, 4])
@pytest.mark.parametrize("protocol", sorted(PROTOCOLS))
def test_plan_matches_reference(protocol, dim):
    jp, tp = _plans(protocol, dim)
    for k in ("L0", "Cp", "Cm", "rho0s"):
        assert getattr(tp, k).shape == getattr(jp, k).shape, k
        assert _rel(getattr(tp, k), getattr(jp, k)) <= 1e-12, k
    for k in ("amps", "phases", "dts"):
        assert _rel(getattr(tp.schedule, k), getattr(jp.schedule, k)) <= 1e-12, k
    assert (tp.schedule.dets is None) == (jp.schedule.dets is None)
    for k in jp.kets:
        np.testing.assert_array_equal(tp.kets[k], jp.kets[k])
    gj, gt = jsim.plan_phase_frame(jp), tsim.plan_phase_frame(tp)
    assert (gj is None) == (gt is None)
    if gj is not None:
        np.testing.assert_array_equal(gt, gj)
    assert tsim.plan_squaring_bound(tp) == jsim.plan_squaring_bound(jp)
    for k in ("Omega", "V", "Delta", "tau_single", "tau_total", "R",
              "delta_zeeman", "delta_stark", "U0_mK"):
        assert _rel(getattr(tp, k), getattr(jp, k)) <= 1e-12, k
    assert tp.protocol == jp.protocol and tp.n_pulses == jp.n_pulses
    assert tp.noise_breakdown.keys() == jp.noise_breakdown.keys()


def test_phase_frame_eligibility():
    """Smooth-JP (uniform amp, dt) is phase-frame eligible; bang-bang
    (unequal segment lengths) is not, in both packages."""
    jp, tp = _plans("smooth_jp", 3)
    assert tsim.plan_phase_frame(tp) is not None
    jp, tp = _plans("bangbang", 3)
    assert tsim.plan_phase_frame(tp) is None


def test_precision_policy_tf32_off():
    import noisyquantumsimulator_tpu_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


_HYGIENE = """
import subprocess, sys
calls = []
_Popen = subprocess.Popen
class Spy(_Popen):
    def __init__(self, *a, **k):
        calls.append(a)
        super().__init__(*a, **k)
subprocess.Popen = Spy
import noisyquantumsimulator_tpu_torch as p
from noisyquantumsimulator_tpu_torch import _kernels, bench_gate
from noisyquantumsimulator_tpu_torch.core import atom_data, configs, constants
from noisyquantumsimulator_tpu_torch.physics import (laser, noise_rates, protocols,
                                                     pulses, trap)
from noisyquantumsimulator_tpu_torch.ops import (expm, expm_cuda, hamiltonians,
                                                 hilbert, lindblad, phase_frame)
from noisyquantumsimulator_tpu_torch.solver import propagator, real_rep, scan_cuda
from noisyquantumsimulator_tpu_torch.gate import fidelity, simulate
from noisyquantumsimulator_tpu_torch import bench_bb, qec
from noisyquantumsimulator_tpu_torch.qec import (bp_cuda, circuits, dem, dem_decoder,
                                                fast_sampler, ldpc, native)
from noisyquantumsimulator_tpu_torch import optimize
from noisyquantumsimulator_tpu_torch.optimize import (apparatus, cost, de, engine,
                                                      forward, inverse,
                                                      jp_legacy, sweeps)
from noisyquantumsimulator_tpu_torch import channels
from noisyquantumsimulator_tpu_torch.channels import (calibration, conversions,
                                                      pauli, tomography)
from noisyquantumsimulator_tpu_torch.utils import math
from noisyquantumsimulator_tpu_torch.gate import (cooling, ms_gate, open_system,
                                                 raman_gate, readout)
from noisyquantumsimulator_tpu_torch.physics import trapped_ions
from noisyquantumsimulator_tpu_torch import primitives
from noisyquantumsimulator_tpu_torch.primitives import (backend, base,
                                                       calibration_io, gates,
                                                       ion_backend, motion)
from noisyquantumsimulator_tpu_torch import (bench, bench_qec, diagnose_bb,
                                             validate_bangbang)
from noisyquantumsimulator_tpu_torch import studies
from noisyquantumsimulator_tpu_torch.studies import (
    decoder_accuracy_study, grape_optimal_control, gross_code_study, qec_scale_study,
    qec_study, research_parameter_sweeps)
from noisyquantumsimulator_tpu_torch.studies import (
    cavity_gate_engine_study, demo_notebook, generate_figures, ion_memory,
    ms_gate_engine_study, multichip_scaling, nn_decoder_study)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m.startswith("noisyquantumsimulator_tpu."))
assert not bad, bad
assert not calls, calls
assert _kernels._lib is None
assert native._lib is None
print("OK")
"""


def test_import_hygiene_no_jax_no_build():
    """Importing the port and every submodule (the QEC path, bench_bb, the
    optimizer, the channel bridge, the primitives with their gate engines,
    the bench records, the two bang-bang scripts and all the studies
    included) loads no JAX, none of the JAX package, and starts no process
    (so neither nvcc nor g++)."""
    out = subprocess.run([sys.executable, "-c", _HYGIENE], capture_output=True,
                         text=True, timeout=300)
    assert "OK" in out.stdout, out.stderr[-2000:]
