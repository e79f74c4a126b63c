"""The port's CUDA kernels against their plain twins, on the card only.

Marked `cuda`; each test skips where torch sees no CUDA device. This file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: float32 1e-4 and complex64 1e-5 relative to max|twin| (the
kernel and the library product sum in different orders); float64 and
complex128 1e-12.
"""
import numpy as np
import pytest
import torch

from noisyquantumsimulator_tpu_torch.ops.expm_cuda import (
    _masked_squaring_plain, fused_masked_squaring)
from noisyquantumsimulator_tpu_torch.solver.scan_cuda import (
    _evolve_real_phased_many_plain, evolve_real_phased_many_cuda)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.float64: 1e-12,
       torch.complex64: 1e-5, torch.complex128: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scan_inputs(D, P, B, S, n_seg, seed=3):
    rng = np.random.default_rng(seed)
    n = D + 2 * P
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    cq = rng.integers(1, 5, P).astype(np.float64)
    ph = rng.standard_normal((B, n_seg))
    x0 = rng.standard_normal((S, n))
    return Q, cq, ph, x0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D,P,B,S,n_seg", [
    (9, 36, 37, 5, 50),      # dim-3 layout, ragged last block
    (16, 120, 9, 5, 20),     # dim-4 layout, U^T from global memory
    (2, 3, 5, 7, 9),         # tiny n, S not dividing anything
    (9, 36, 3, 20, 4),       # many rows per schedule
])
def test_phase_scan_kernel_matches_twin(cuda, dtype, D, P, B, S, n_seg):
    args = [torch.as_tensor(a, device=cuda).to(dtype)
            for a in _scan_inputs(D, P, B, S, n_seg)]
    before = evolve_real_phased_many_cuda.launches
    got = evolve_real_phased_many_cuda(*args, D, P)
    assert evolve_real_phased_many_cuda.launches == before + 1
    ref = _evolve_real_phased_many_plain(*args, D, P)
    torch.cuda.synchronize()
    assert got.shape == (B, S, D + 2 * P) and got.dtype == dtype
    assert float((got - ref).abs().max()) <= TOL[dtype] * float(ref.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex64, torch.complex128])
@pytest.mark.parametrize("B,N,max_sq", [(1, 81, 5), (7, 33, 4), (2, 256, 3),
                                        (3, 16, 0)])
def test_masked_squaring_kernel_matches_twin(cuda, dtype, B, N, max_sq):
    rng = np.random.default_rng(N)
    A = rng.standard_normal((B, N, N))
    if dtype.is_complex:
        A = A + 1j * rng.standard_normal((B, N, N))
    R = torch.as_tensor(np.eye(N) + A / (4 * N), device=cuda).to(dtype)
    s = torch.as_tensor(rng.integers(0, max_sq + 2, B), device=cuda,
                        dtype=torch.int32)
    before = fused_masked_squaring.launches
    got = fused_masked_squaring(R, s, max_sq)
    assert fused_masked_squaring.launches == before + max_sq
    ref = _masked_squaring_plain(R, s, max_sq)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= TOL[dtype] * float(ref.abs().max())


def test_kernels_reject_unsupported_dtypes(cuda):
    R = torch.zeros((1, 4, 4), dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError):
        fused_masked_squaring(R, torch.ones(1, dtype=torch.int32, device=cuda), 2)
    args = [torch.as_tensor(a, device=cuda).to(torch.float16)
            for a in _scan_inputs(2, 3, 2, 5, 3)]
    with pytest.raises(TypeError):
        evolve_real_phased_many_cuda(*args, 2, 3)


def test_simulate_cz_gate_cuda_matches_cpu(cuda):
    from noisyquantumsimulator_tpu_torch.core.configs import (
        SmoothJPSimulationInputs)
    from noisyquantumsimulator_tpu_torch.gate.simulate import simulate_cz_gate
    kw = dict(n_steps_smooth=60, dtype=torch.complex128)
    rc = simulate_cz_gate(SmoothJPSimulationInputs(), device=cuda, **kw)
    rh = simulate_cz_gate(SmoothJPSimulationInputs(), device="cpu", **kw)
    assert abs(rc.avg_fidelity - rh.avg_fidelity) <= 1e-10
    assert abs(rc.phase_info["controlled_phase_rad"]
               - rh.phase_info["controlled_phase_rad"]) <= 1e-10
