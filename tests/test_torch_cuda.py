"""The port's CUDA kernels against their plain twins, on the card only.

Marked `cuda`; each test skips where torch sees no CUDA device. This file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: float32 1e-4 and complex64 1e-5 relative to max|twin| (the
kernels and the library products sum in different orders; K1's float32
product is the 3xTF32 split on the tensor cores); float64 and
complex128 1e-12. The min-sum c2v kernel K3 is bit-exact against its twin
at float32 and bfloat16 (one rounding of the same exact product); the v2c
kernel rounds where its twin's torch ops round, so it may differ only by the
order of a float32 sum of <= d_max terms: hard decisions equal, beliefs
within one storage ulp, each reported with how many differ. OSD-0's kernel
is bit-exact against its twin, the host C++ OSD-0, at the gross code's DEM.
The surface-code matchers (plain torch ops, no kernel of their own) are
bit-identical on the card and on the CPU. The sampler kernel is bit-exact
against its twin, the op route, fed the same draws, and draws the stated
Philox stream; its detector (and the gross code's pair) rates lie within 5
binomial sigma of the DEM's analytic rates. The architecture
loop's executor (torch ops) gives per-qubit frame rates within 5 binomial
sigma of their exact marginals (`exact_frame_rates`, shared with the CPU
tests); the density-matrix simulator on the card equals the CPU's to 1e-6.
"""
import numpy as np
import pytest
import torch

from noisyquantumsimulator_tpu_torch.qec import bp_cuda, osd_cuda
from noisyquantumsimulator_tpu_torch.ops.expm_cuda import (
    _masked_squaring_plain, fused_masked_squaring)
from noisyquantumsimulator_tpu_torch.solver.scan_cuda import (
    _evolve_real_phased_many_plain, evolve_real_phased_many_cuda)
from noisyquantumsimulator_tpu_torch.solver.population_scan_cuda import (
    _evolve_real_phased_population_plain, evolve_real_phased_population_cuda,
    resident)

from _json_close import close as json_close

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
    (9, 36, 60, 5, 300),     # dim-3 layout, the full 300 steps, 3 blocks
    (16, 120, 13, 5, 30),    # dim-4 layout, last block holds 1 of 12 schedules
    (9, 36, 4, 5, 1),        # a single step
    (16, 120, 1, 5, 300),    # one schedule, S = 5, the full 300 steps
    (2, 3, 3, 150, 3),       # S larger than one block's default rows
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


_POP_U = {}


def _population_inputs(cuda, D, P, M, S, n_seg, dtype, per_member, seed=7):
    """One orthogonal U per member (QR of normal matrices, cached per (n, M)),
    integer charges, phases and states; states shared (S, n) or (M, S, n)."""
    n = D + 2 * P
    if (n, M) not in _POP_U:
        g = torch.Generator().manual_seed(seed)
        _POP_U[(n, M)] = torch.linalg.qr(
            torch.randn(M, n, n, generator=g, dtype=torch.float64))[0]
    rng = np.random.default_rng(seed + M + n_seg)
    cq = rng.integers(1, 5, P).astype(np.float64)
    ph = rng.standard_normal((M, n_seg))
    x0 = rng.standard_normal((M, S, n) if per_member else (S, n))
    return [torch.as_tensor(a, device=cuda).to(dtype)
            for a in (_POP_U[(n, M)], cq, ph, x0)]


@pytest.mark.parametrize("per_member", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_seg", [1, 40, 300])
@pytest.mark.parametrize("M", [1, 7, 1024])
def test_population_scan_kernel_matches_twin(cuda, M, n_seg, dtype, per_member):
    """The population-scan kernel against its twin (the batched-product
    loop) at the optimizer's n = 81, S = 5: one launch a call."""
    args = _population_inputs(cuda, 9, 36, M, 5, n_seg, dtype, per_member)
    before = (evolve_real_phased_population_cuda.launches,
              evolve_real_phased_population_cuda.loop_calls)
    with torch.no_grad():
        got = evolve_real_phased_population_cuda(*args, 9, 36)
    assert (evolve_real_phased_population_cuda.launches,
            evolve_real_phased_population_cuda.loop_calls) == (
                before[0] + 1, before[1])
    ref = _evolve_real_phased_population_plain(*args, 9, 36)
    torch.cuda.synchronize()
    assert got.shape == (M, 5, 81) and got.dtype == dtype
    assert float((got - ref).abs().max()) <= TOL[dtype] * float(ref.abs().max())


@pytest.mark.parametrize("D,P,S", [(2, 3, 7), (4, 6, 1), (9, 36, 12),
                                   (12, 66, 5)])
def test_population_scan_kernel_other_shapes(cuda, D, P, S):
    """Widths other than 81 (one to five columns a lane) and row counts that
    are not 5, in both dtypes."""
    for dtype in (torch.float32, torch.float64):
        args = _population_inputs(cuda, D, P, 9, S, 30, dtype, S % 2 == 0)
        before = evolve_real_phased_population_cuda.launches
        got = evolve_real_phased_population_cuda(*args, D, P)
        assert evolve_real_phased_population_cuda.launches == before + 1
        ref = _evolve_real_phased_population_plain(*args, D, P)
        torch.cuda.synchronize()
        assert float((got - ref).abs().max()) <= TOL[dtype] * float(ref.abs().max())


def test_population_scan_loop_routes_are_counted(cuda):
    """n = 256 (no member fits a block) and a recorded autograd graph take
    the loop on the card, each counted once and launching no kernel."""
    pscan = evolve_real_phased_population_cuda
    args = _population_inputs(cuda, 16, 120, 2, 5, 6, torch.float32, False)
    before = (pscan.launches, pscan.loop_calls)
    got = pscan(*args, 16, 120)
    assert (pscan.launches, pscan.loop_calls) == (before[0], before[1] + 1)
    torch.testing.assert_close(got, _evolve_real_phased_population_plain(
        *args, 16, 120), rtol=0, atol=0)
    U, cq, ph, x0 = _population_inputs(cuda, 9, 36, 1, 5, 6, torch.float64, False)
    ph = ph.clone().requires_grad_(True)
    out = pscan(U, cq, ph, x0, 9, 36)
    assert (pscan.launches, pscan.loop_calls) == (before[0], before[1] + 2)
    g, = torch.autograd.grad(out.sum(), ph)
    assert g.shape == ph.shape and bool(torch.isfinite(g).all())
    with torch.no_grad():
        pscan(U, cq, ph, x0, 9, 36)
    assert (pscan.launches, pscan.loop_calls) == (before[0] + 1, before[1] + 2)


def test_population_scan_residency_rule_is_the_kernels(cuda):
    from noisyquantumsimulator_tpu_torch import _kernels
    lib = _kernels.load()
    for dtype, size in ((torch.float32, 4), (torch.float64, 8)):
        for n in (1, 8, 16, 81, 160, 170, 236, 240, 256, 257):
            for S in (1, 5, 6, 300):
                assert resident(n, S, dtype) == bool(
                    lib.nqs_population_scan_is_resident(n, S, size)), (n, S, dtype)


def test_population_objective_cuda_matches_cpu(cuda):
    """make_population_objective("smooth_jp") on the card (the kernel)
    against the CPU (the loop) at complex64: fidelities within 1e-4, the
    cost within 5e-3 relative."""
    import warnings
    from noisyquantumsimulator_tpu_torch.optimize import engine, forward
    from noisyquantumsimulator_tpu_torch.optimize.apparatus import (
        ApparatusConstraints)
    app = ApparatusConstraints()
    bounds, x0 = forward.get_smooth_jp_bounds_and_x0()
    b = np.asarray(bounds, float)
    rng = np.random.default_rng(11)
    pop = np.clip(x0[None] * (1.0 + 0.1 * rng.uniform(-1.0, 1.0, (64, len(x0)))),
                  b[:, 0], b[:, 1])
    out = {}
    for dev in ("cpu", cuda):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            prob = engine.build_fixed_problem(app, app.make_full_noise(),
                                              device=dev, dtype=torch.complex64)
        before = evolve_real_phased_population_cuda.launches
        out[str(dev)] = engine.make_population_objective(prob, "smooth_jp")(
            torch.as_tensor(pop, device=dev))
        assert evolve_real_phased_population_cuda.launches == before + (
            dev != "cpu")
    (cc, mc), (ch, mh) = out["cuda"], out["cpu"]
    assert float(((cc.cpu() - ch).abs() / ch.abs()).max()) <= 5e-3
    for k in ("avg_fidelity", "f00", "f01", "f10", "f11", "cz_phase_fidelity"):
        assert float((mc[k].cpu() - mh[k]).abs().max()) <= 1e-4, k


def _k2_launches(N, max_sq):
    """Launches of one chain: none for an empty loop, one on the resident
    route (N = 81 and below fit at every dtype), one per trip when tiled
    (N = 256 and above at every dtype)."""
    return 0 if max_sq == 0 else 1 if N <= 81 else max_sq


def _k2_check(cuda, dtype, R, s, max_sq):
    before = fused_masked_squaring.launches
    got = fused_masked_squaring(R, s, max_sq)
    N = R.shape[-1]
    assert fused_masked_squaring.launches == before + _k2_launches(N, max_sq)
    ref = _masked_squaring_plain(R, s, max_sq)
    torch.cuda.synchronize()
    assert got.shape == R.shape and got.dtype == dtype
    assert got.data_ptr() != R.data_ptr()
    assert float((got - ref).abs().max()) <= TOL2[dtype] * float(ref.abs().max())


# K2 against its twin: 1e-5 relative at 32 bits, 1e-12 at 64
TOL2 = {torch.float32: 1e-5, torch.float64: 1e-12,
        torch.complex64: 1e-5, torch.complex128: 1e-12}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex64, torch.complex128])
@pytest.mark.parametrize("B,N,max_sq", [(1, 81, 5), (7, 33, 4), (2, 256, 3),
                                        (3, 16, 0), (5, 1, 3), (3, 130, 4),
                                        (2, 300, 2), (4, 64, 1), (3, 131, 3),
                                        (2, 170, 2)])
def test_masked_squaring_kernel_matches_twin(cuda, dtype, B, N, max_sq):
    rng = np.random.default_rng(N)
    A = rng.standard_normal((B, N, N))
    if dtype.is_complex:
        A = A + 1j * rng.standard_normal((B, N, N))
    R = torch.as_tensor(np.eye(N) + A / (4 * N), device=cuda).to(dtype)
    s = torch.as_tensor(rng.integers(0, max_sq + 2, B), device=cuda,
                        dtype=torch.int32)
    if N > 81 and not (N == 256 or dtype == torch.complex128):
        # between the two routes the launch count depends on the dtype; odd
        # N and 170 x float32 have rows that are no whole 16-byte words, so
        # the tiled route stages them element by element
        got = fused_masked_squaring(R, s, max_sq)
        ref = _masked_squaring_plain(R, s, max_sq)
        assert float((got - ref).abs().max()) <= TOL2[dtype] * float(ref.abs().max())
        return
    _k2_check(cuda, dtype, R, s, max_sq)


def _batched_inputs(cuda, B, N, dtype, s_kind, seed=9):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    R = torch.randn((B, N, N), dtype=dtype, device=cuda, generator=gen)
    R = torch.eye(N, dtype=dtype, device=cuda) + R * (0.05 / N ** 0.5)
    if s_kind == "mixed":
        s = torch.randint(0, 7, (B,), device=cuda, generator=gen,
                          dtype=torch.int32)
    else:
        s = torch.full((B,), s_kind, device=cuda, dtype=torch.int32)
    return R, s


@pytest.mark.parametrize("B,N,dtype,max_sq,s_kind", [
    (15, 81, torch.float32, 12, 3),          # a default DE generation
    (1024, 81, torch.float32, 12, 3),        # a card-sized population
    (1024, 81, torch.float32, 12, "mixed"),
    (75, 81, torch.complex64, 12, 3),        # bang-bang, P = 15
    (5120, 81, torch.complex64, 12, 3),      # bang-bang, P = 1024
    (300, 81, torch.complex64, 4, 3),        # per-segment engine, dim 3
    (300, 256, torch.complex64, 4, 3),       # per-segment engine, dim 4
    (7, 256, torch.complex64, 12, "mixed"),  # tiled route, chains of all lengths
    (64, 81, torch.complex128, 12, "mixed"),
    (64, 81, torch.float64, 12, "mixed"),
    (300, 81, torch.complex64, 2, 3),        # max_squarings below every s
    (9, 256, torch.float32, 2, "mixed"),
    (1, 540, torch.float64, 6, 6),           # readout: tiled, 16-byte copies
    (1, 539, torch.float64, 6, 6),           # tiled, element copies
    (1, 81, torch.float64, 12, 12),          # cooling: resident, 12 squarings
    (7, 1600, torch.complex128, 4, 4),       # MS gate: tiled, ping-pong to out
    (3, 1600, torch.complex128, 4, "mixed"),
])
def test_masked_squaring_kernel_batched_shapes(cuda, B, N, dtype, max_sq, s_kind):
    """Both routes at the shapes the optimizer and the per-segment engine
    launch, uniform and mixed squaring counts."""
    R, s = _batched_inputs(cuda, B, N, dtype, s_kind)
    _k2_check(cuda, dtype, R, s, max_sq)


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64,
                                   torch.complex128])
@pytest.mark.parametrize("B,N", [(33, 81), (5, 256)])
def test_masked_squaring_kernel_all_masked(cuda, dtype, B, N):
    """Every matrix masked out from trip 0 (s = 0, as the zero-length
    segments of a bang-bang schedule give): the output is the input, bit
    for bit, in a new buffer."""
    R, s = _batched_inputs(cuda, B, N, dtype, 0)
    got = fused_masked_squaring(R, s, 12)
    torch.cuda.synchronize()
    assert got.data_ptr() != R.data_ptr()
    assert torch.equal(got, R)


def _unitary_chain(cuda, B, N, dtype, s, seed=13):
    """Squaring inputs whose chains stay bounded at any s: R = Taylor-16 of
    K / 2^s with K skew-Hermitian (skew-symmetric for real dtypes), scaled
    to ||K / 2^s||_1 = 1.8, so R^(2^s) is close to the unitary exp(K)."""
    from noisyquantumsimulator_tpu_torch.ops.expm import _taylor16
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    X = torch.randn((B, N, N), dtype=dtype, device=cuda, generator=gen)
    K = X - X.mH
    As = K * (1.8 / K.abs().sum(-2).amax(-1))[:, None, None]
    I = torch.eye(N, dtype=dtype, device=cuda).expand(As.shape)
    G = torch.randn((B, N, N), dtype=dtype, device=cuda, generator=gen)
    return _taylor16(As, I).contiguous(), s.to(cuda), G


@pytest.mark.parametrize("B,N,dtype,s", [
    (1, 81, torch.float32, [3]),                 # the real core's expm
    (5, 81, torch.complex64, [9, 10, 11, 10, 9]),  # bang-bang's segments
    (2, 256, torch.complex64, [3, 3]),           # the tiled route
    (4, 81, torch.complex128, [0, 2, 5, 1]),     # mixed, one masked from trip 0
])
def test_masked_squaring_backward_matches_twin_autograd(cuda, B, N, dtype, s):
    """K2's Function gradient (forward K2, trips recomputed with K2, reverse
    loop in torch.matmul) against autograd through the plain twin; the
    backward's recompute is one launch a trip on either route."""
    ms = 12 if N <= 81 else 4
    R, s, G = _unitary_chain(cuda, B, N, dtype, torch.tensor(s, dtype=torch.int32))
    Rk = R.clone().requires_grad_(True)
    before = fused_masked_squaring.launches
    Y = fused_masked_squaring(Rk, s, ms)
    assert fused_masked_squaring.launches == before + _k2_launches(N, ms)
    got, = torch.autograd.grad((Y * G).real.sum(), Rk)
    T = int(s.max())
    assert fused_masked_squaring.launches == before + _k2_launches(N, ms) + T - 1
    Rp = R.clone().requires_grad_(True)
    ref, = torch.autograd.grad((_masked_squaring_plain(Rp, s, ms) * G).real.sum(), Rp)
    torch.cuda.synchronize()
    rel = float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))
    assert rel <= (1e-5 if dtype in (torch.float32, torch.complex64) else 1e-12)


def test_value_and_grad_cuda_matches_cpu(cuda):
    import warnings
    from noisyquantumsimulator_tpu_torch.optimize import engine, forward
    from noisyquantumsimulator_tpu_torch.optimize.apparatus import (
        ApparatusConstraints)
    app = ApparatusConstraints()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        prob = engine.build_fixed_problem(app, app.make_full_noise(),
                                          dtype=torch.complex128, device="cpu")
    for protocol, x, kw in (
            ("smooth_jp", forward.get_smooth_jp_bounds_and_x0()[1],
             {"n_steps": 60}),
            ("jp_bangbang", forward.get_jp_bangbang_bounds_and_x0(5)[1],
             {"n_segments": 5})):
        cc, gc = engine.make_value_and_grad(prob, protocol, device=cuda, **kw)(x)
        ch, gh = engine.make_value_and_grad(prob, protocol, **kw)(x)
        assert gc.device.type == "cuda"
        assert abs(float(cc) - float(ch)) <= 1e-10 * abs(float(ch))
        assert float(torch.linalg.norm(gc.cpu() - gh)) <= 1e-9 * float(
            torch.linalg.norm(gh))


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


def _c2v_inputs(w, n_chk, S, seed=0):
    """LLR-like messages with padding slabs, ties and exact zeros."""
    rng = np.random.default_rng(seed)
    m = 4 * rng.standard_normal((w, n_chk, S), dtype=np.float32)
    m[w - 1, ::2] = 1e30
    m[1, :, ::7] = m[0, :, ::7]
    m[2, :, 3::11] = 0.0
    sgn = np.where(rng.random((n_chk, S)) < 0.5, -1.0, 1.0).astype(np.float32)
    return m, sgn


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(26, 288, 65536), (26, 288, 512),
                                   (7, 13, 1000), (32, 3, 129)])
def test_c2v_kernel_bit_exact_vs_twin(cuda, dtype, shape):
    m, sgn = _c2v_inputs(*shape)
    msg = torch.as_tensor(m, device=cuda).to(dtype)
    ss = torch.as_tensor(sgn, device=cuda).to(dtype)
    before = bp_cuda.c2v.launches
    got = bp_cuda.c2v(msg, ss, 0.75)
    assert bp_cuda.c2v.launches == before + 1
    ref = bp_cuda._c2v_plain(msg, ss, 0.75)
    torch.cuda.synchronize()
    assert got.shape == shape and got.dtype == dtype
    assert float((got.float() - ref.float()).abs().max()) == 0.0


def test_c2v_kernel_rejects_unsupported(cuda):
    m = torch.ones((5, 4, 64), device=cuda)
    s = torch.ones((4, 64), device=cuda)
    with pytest.raises(TypeError):
        bp_cuda.c2v(m.half(), s.half(), 0.75)
    with pytest.raises(ValueError):
        bp_cuda.c2v(m.transpose(1, 2).contiguous().transpose(1, 2), s, 0.75)
    with pytest.raises(ValueError):
        bp_cuda.c2v(torch.ones((bp_cuda.MAX_SLOTS + 1, 4, 64), device=cuda), s,
                    0.75)
    before = bp_cuda.c2v.launches
    with pytest.raises(ValueError):
        bp_cuda.c2v(m, s[:, :32], 0.75)
    assert bp_cuda.c2v.launches == before


@pytest.fixture(scope="module")
def bb_graphs():
    """The gross code's DEM (3 rounds) and the small BB code's (2 rounds),
    both at p = 1e-3: circuit, slot tables (numpy) and priors (float32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from noisyquantumsimulator_tpu_torch.qec import ldpc
    from noisyquantumsimulator_tpu_torch.qec.dem_decoder import dem_arrays
    out = {}
    for name, code, rounds in (("gross", ldpc.gross_code(), 3),
                               ("small", ldpc.small_bb_code(), 2)):
        c = ldpc.bb_memory_circuit(*code, rounds, 1e-3)
        H, _, probs = dem_arrays(c)
        chk, var = np.nonzero(H)
        tables = ldpc.build_slot_tables(chk.astype(np.int64), var.astype(np.int64),
                                        *H.shape)
        out[name] = (c, tables, np.log((1.0 - probs) / probs).astype(np.float32))
    # a random Tanner graph with variable degrees up to 8: the kernel's wider
    # degree tier
    rng = np.random.default_rng(4)
    n_chk, n_var = 40, 90
    var = np.repeat(np.arange(n_var), rng.integers(1, 9, n_var))
    chk = np.concatenate([rng.choice(n_chk, k, replace=False)
                          for k in np.bincount(var, minlength=n_var)])
    out["random"] = (None, ldpc.build_slot_tables(chk, var, n_chk, n_var), None)
    return out


def _ulps(x, dtype):
    """The spacing of `dtype` at each |x| (x float32)."""
    frac_bits = {torch.bfloat16: 7, torch.float32: 23}[dtype]
    _, e = torch.frexp(x.abs())
    return torch.ldexp(torch.ones_like(x), e - 1 - frac_bits)


def _v2c_card_operands(tables, S, dtype, device, seed=0, dyadic=False):
    """K3-like messages (NaN in the check layout's padding, which no one may
    read), the previous messages (+big in the padding), priors. dyadic: the
    messages on the grid 1/16, where float32 sums of a few of them are exact
    in any order."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    Ec, pad = tables["Ec"], tables["pad_c"]
    n_var = tables["cpos_of_vslot"].numel() // tables["d_max"]
    msg_cv = 4 * torch.randn((Ec, S), generator=g, device=device)
    if dyadic:
        msg_cv = torch.round(16 * msg_cv) / 16
    msg_cv[pad] = float("nan")
    msg_cv[::5, ::7] = 0.0
    msg_vc = 4 * torch.randn((Ec, S), generator=g, device=device)
    msg_vc[pad] = bp_cuda.BIG
    llr = 2 + 6 * torch.rand(n_var, generator=g, device=device)
    return msg_cv.to(dtype), llr.to(dtype), msg_vc.to(dtype)


@pytest.mark.parametrize("graph,dtype,damping,S", [
    ("gross", torch.bfloat16, 0.0, 65536),     # the fast tier's shape
    ("gross", torch.float32, 0.5, 512),        # the retry tier's shape
    ("gross", torch.bfloat16, 0.5, 1003),
    ("gross", torch.float32, 0.0, 1003),
    ("small", torch.bfloat16, 0.0, 777),
    ("small", torch.bfloat16, 0.5, 777),
    ("small", torch.float32, 0.0, 129),
    ("small", torch.float32, 0.5, 129),
    ("random", torch.bfloat16, 0.5, 1003),
    ("random", torch.float32, 0.0, 129),
])
def test_v2c_kernel_matches_twin(cuda, bb_graphs, graph, dtype, damping, S):
    """Messages and beliefs against the twin on the same card; degree-2
    variables carry the sentinel slot, S is ragged but at 65536, and the
    random graph takes the kernel's wider degree tier. The twin's torch sum
    adds more than 3 float32 terms in another order than the kernel's slot
    order (beliefs then differ by several ulps, not by one), so the random
    graph's messages lie on a grid where every order sums exactly."""
    from noisyquantumsimulator_tpu_torch.qec import ldpc
    _, tables_np, _ = bb_graphs[graph]
    tables = ldpc.slot_tables_on(tables_np, cuda)
    msg_cv, llr, msg_vc = _v2c_card_operands(tables, S, dtype, cuda,
                                             dyadic=graph == "random")
    before = bp_cuda.v2c.launches
    bel = bp_cuda.v2c(msg_cv, llr, tables)
    got = bp_cuda.v2c(msg_cv, llr, tables, msg_vc.clone(), damping)
    assert bp_cuda.v2c.launches == before + 2
    bel_ref = bp_cuda._v2c_plain(msg_cv, llr, tables)
    ref = bp_cuda._v2c_plain(msg_cv, llr, tables, msg_vc.clone(), damping)
    torch.cuda.synchronize()
    assert bel.shape == (llr.shape[0], S) and bel.dtype == dtype
    assert got.shape == msg_vc.shape and got.dtype == dtype
    pad = tables["pad_c"]
    assert torch.equal(got[pad], msg_vc[pad]), "padding slots written"
    assert bool(torch.isfinite(bel.float()).all() and torch.isfinite(got.float()).all())
    n_bel = int((bel != bel_ref).sum())
    n_msg = int((got != ref).sum())
    print(f"v2c {graph} {dtype} damping {damping} S {S}: beliefs differ at "
          f"{n_bel} of {bel.numel()}, messages at {n_msg} of {int((~pad).sum()) * S}")
    assert torch.equal(bel < 0, bel_ref < 0)
    d_bel = (bel.float() - bel_ref.float()).abs()
    assert bool((d_bel <= _ulps(bel_ref.float(), dtype)).all())
    # a message is total - c2v: where the variable's total moved by one ulp
    # the message moves by at most one ulp of the total, plus its own rounding
    tot = bel_ref.float().index_select(0, tables["var_of_cpos"])[~pad]
    d_msg = (got.float() - ref.float()).abs()[~pad]
    assert bool((d_msg <= 2 * _ulps(tot, dtype)).all())
    if n_bel == 0:
        assert n_msg == 0


@pytest.mark.parametrize("damping", [0.0, 0.5])
def test_v2c_kernel_generic_sums_within_order_bound(cuda, bb_graphs, damping):
    """The random graph's wider degree tier on generic float32 messages,
    where the twin's torch sum of up to 8 terms runs in another order than
    the kernel's slot order. Each float32 sum of d terms lies within
    (d - 1) * u * A of the exact one (u = 2^-24, A = |prior| + the sum of
    the variable's |messages|), so the two beliefs differ by at most
    2 * d_max ulps of A, rounding included; a message, total - c2v rounded
    and then blended, by 2 * d_max + 2 ulps of A + |old message|."""
    from noisyquantumsimulator_tpu_torch.qec import ldpc
    tables = ldpc.slot_tables_on(bb_graphs["random"][1], cuda)
    d_max, S = tables["d_max"], 1003
    msg_cv, llr, msg_vc = _v2c_card_operands(tables, S, torch.float32, cuda, seed=3)
    bel = bp_cuda.v2c(msg_cv, llr, tables)
    got = bp_cuda.v2c(msg_cv, llr, tables, msg_vc.clone(), damping)
    bel_ref = bp_cuda._v2c_plain(msg_cv, llr, tables)
    ref = bp_cuda._v2c_plain(msg_cv, llr, tables, msg_vc.clone(), damping)
    A = bp_cuda._v2c_plain(msg_cv.abs().double(), llr.abs().double(), tables).float()
    torch.cuda.synchronize()
    pad = tables["pad_c"]
    assert torch.equal(got[pad], msg_vc[pad]), "padding slots written"
    d_bel = (bel - bel_ref).abs()
    bound_bel = 2 * d_max * _ulps(A, torch.float32)
    A_msg = A.index_select(0, tables["var_of_cpos"]) + msg_vc.abs()
    d_msg = (got - ref).abs()[~pad]
    bound_msg = ((2 * d_max + 2) * _ulps(A_msg, torch.float32))[~pad]
    print(f"v2c random float32 damping {damping}: beliefs differ at "
          f"{int((d_bel > 0).sum())} of {bel.numel()} (at most "
          f"{float((d_bel / _ulps(A, torch.float32)).max()):.2f} ulps of A), messages "
          f"at {int((d_msg > 0).sum())} of {d_msg.numel()}")
    assert bool((d_bel <= bound_bel).all())
    assert bool((d_msg <= bound_msg).all())
    sure = bel_ref.abs() > bound_bel
    assert torch.equal((bel < 0)[sure], (bel_ref < 0)[sure])


@pytest.mark.parametrize("tier", ["fast", "retry"])
def test_bp_slots_cuda_matches_cpu(cuda, bb_graphs, tier):
    """`_bp_slots` on the card against the same on the CPU (the twins), at
    the gross code's tiers: 6 bfloat16 iterations, or 90 damped float32
    ones; K3 and the v2c kernel each launch n_iters + 1 times."""
    from noisyquantumsimulator_tpu_torch.qec import ldpc
    from noisyquantumsimulator_tpu_torch.qec.fast_sampler import build_fast_sampler
    circuit, tables_np, llr = bb_graphs["gross"]
    n_chk = circuit.n_detectors
    n_var = llr.shape[0]
    S, kw = ((2048, dict(n_iters=6, dtype=torch.bfloat16)) if tier == "fast"
             else (512, dict(n_iters=90, damping=0.5)))
    gen = torch.Generator(device=cuda)
    gen.manual_seed(17)
    syn = build_fast_sampler(circuit, S, cuda)(gen)["detectors"].float()
    llr_t = torch.as_tensor(llr)
    v0, c0 = bp_cuda.v2c.launches, bp_cuda.c2v.launches
    hg, bg = ldpc._bp_slots(syn, llr_t.to(cuda), ldpc.slot_tables_on(tables_np, cuda),
                            n_chk, n_var, scale=0.75, **kw)
    assert bp_cuda.v2c.launches == v0 + kw["n_iters"] + 1
    assert bp_cuda.c2v.launches == c0 + kw["n_iters"] + 1
    hc, bc = ldpc._bp_slots(syn.cpu(), llr_t, tables_np, n_chk, n_var, scale=0.75, **kw)
    hg, bg = hg.cpu(), bg.cpu()
    dt = kw.get("dtype", torch.float32)
    n_bel = int((bg != bc).sum())
    print(f"_bp_slots {tier}: beliefs differ at {n_bel} of {bc.numel()}, hard "
          f"decisions at {int((hg != hc).sum())}")
    assert torch.equal(hg, hc)
    assert bool(((bg - bc).abs() <= _ulps(bc, dt)).all())


def test_v2c_kernel_rejects_unsupported(cuda, bb_graphs):
    from noisyquantumsimulator_tpu_torch.qec import ldpc
    tables = ldpc.slot_tables_on(bb_graphs["small"][1], cuda)
    msg_cv, llr, msg_vc = _v2c_card_operands(tables, 64, torch.float32, cuda)
    before = bp_cuda.v2c.launches
    with pytest.raises(TypeError):
        bp_cuda.v2c(msg_cv.half(), llr.half(), tables, msg_vc.half())
    with pytest.raises(ValueError):
        bp_cuda.v2c(msg_cv.t().contiguous().t(), llr, tables, msg_vc)
    with pytest.raises(ValueError):
        bp_cuda.v2c(msg_cv, llr, tables, msg_vc.t().contiguous().t())
    with pytest.raises(ValueError):
        bp_cuda.v2c(msg_cv, llr, tables, msg_cv)
    with pytest.raises(TypeError):
        bp_cuda.v2c(msg_cv, llr, dict(tables, cpos_of_vslot=tables["cpos_of_vslot"].int()),
                    msg_vc)
    with pytest.raises(ValueError):
        bp_cuda.v2c(msg_cv, llr, dict(tables, d_max=bp_cuda.MAX_DEGREE + 1), msg_vc)
    with pytest.raises(ValueError):
        bp_cuda.v2c(msg_cv, llr.cpu(), tables, msg_vc)
    assert bp_cuda.v2c.launches == before


def test_dem_decoder_cuda_matches_cpu(cuda):
    """The tiered decoder at a float32 fast tier gives the same bad flags
    and, on converged shots, the same predictions on the card as on the
    CPU (the kernel is bit-exact; only sums of <= d_max terms may round in
    another order)."""
    from noisyquantumsimulator_tpu_torch.qec import ldpc
    from noisyquantumsimulator_tpu_torch.qec.dem_decoder import (
        DemBPDecoder, decoder_from_numpy)
    from noisyquantumsimulator_tpu_torch.qec.fast_sampler import (
        build_fast_sampler)
    c = ldpc.bb_memory_circuit(*ldpc.small_bb_code(), 2, 3e-3)
    kw = dict(n_iters=25, fast_iters=6, retry_cap_divisor=4)
    dg = DemBPDecoder(c, device=cuda, **kw)
    dc = decoder_from_numpy(dg.H, dg.obs_mask, dg.probs, "cpu", **kw)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    dets = build_fast_sampler(c, 2048, cuda)(gen)["detectors"].float()
    before, before_v = bp_cuda.c2v.launches, bp_cuda.v2c.launches
    pg, bg, _ = dg._full(dets)
    assert bp_cuda.c2v.launches == before + 7 + 38
    assert bp_cuda.v2c.launches == before_v + 7 + 38
    pc, bc, _ = dc._full(dets.cpu())
    assert torch.equal(bg.cpu(), bc)
    assert float((pg.cpu() == pc)[~bc].float().mean()) >= 0.999


@pytest.fixture(scope="module")
def gross_rep():
    """The bb-gross workload on the card (the gross code, 3 rounds, p =
    1e-3, 65536 shots a rep) and one rep's residue block (`cap` rows, the
    n_bad unconverged ones first) at a fixed seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from noisyquantumsimulator_tpu_torch import bench_bb
    w = bench_bb.build_bb_workload(3, 1e-3, 65536, 6, "cuda")
    fails, n_bad, dets, bel, obs = w.e2e(_card_gen(2024))
    return w, int(fails), int(n_bad), dets, bel, obs


def _card_gen(seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("case", ["residue", "ties", "zero", "foreign", "none", "one",
                                  "cap"])
def test_osd0_kernel_bit_exact_vs_twin(cuda, gross_rep, case):
    """OSD-0 on the card equals the host C++ OSD-0 bit for bit at the gross
    code's DEM (288 x 1833, rank 282): the rep's residue rows; the same
    syndromes under beliefs with ties and signed zeros; all-zero
    syndromes; random syndromes H cannot produce (where the row choice
    matters); no row, one row, the whole cap. The observable flips and the
    failures are the estimate's; one launch a call with rows."""
    from noisyquantumsimulator_tpu_torch.qec.native import osd0_batch_native
    w, _, nb, dets, bel, obs = gross_rep
    tab = osd_cuda.tables(w.decoder.H, w.decoder.obs_mask, w.k, cuda)
    assert (tab["m"], tab["n"], tab["rank"]) == (288, 1833, 282) and nb > 0
    rows = {"none": 0, "one": 1, "cap": w.cap}.get(case, nb)
    dets, bel, obs = dets[:rows].contiguous(), bel[:rows].contiguous(), obs[:rows].contiguous()
    g = _card_gen(31)
    if case == "ties":
        bel = torch.round(2 * torch.randn(bel.shape, generator=g, device=cuda))
        bel[:, ::5] = -0.0
        bel[:, 2::5] = 0.0
    elif case == "zero":
        dets = torch.zeros_like(dets)
    elif case == "foreign":
        dets = torch.randint(0, 2, dets.shape, generator=g, device=cuda, dtype=torch.uint8)
    before = osd_cuda.osd0.launches
    est, pred, fail = osd_cuda.osd0(tab, dets, bel, obs)
    torch.cuda.synchronize()
    assert osd_cuda.osd0.launches == before + (rows > 0)
    want = osd0_batch_native(w.decoder.H, dets.cpu().numpy(), bel.cpu().numpy())
    assert est.shape == (rows, 1833) and np.array_equal(est.cpu().numpy(), want)
    bits = (want.astype(np.int64) @ ((w.decoder.obs_mask[:, None] >> np.arange(w.k)) & 1)) & 1
    assert np.array_equal(pred.cpu().numpy(), (bits << np.arange(w.k)).sum(axis=1))
    assert np.array_equal(fail.cpu().numpy(), (bits != obs.cpu().numpy()).any(axis=1))
    if case == "zero":
        assert not want.any()


def test_bb_step_runs_osd0_once_on_the_card(cuda, gross_rep):
    """The step at the rep's seed launches the OSD-0 kernel once, marks its
    n_bad residue rows tier 2, and counts the failures that host OSD-0 of
    the same residue counts."""
    w, fails, nb, dets, bel, obs = gross_rep
    before = osd_cuda.osd0.launches
    out = w.step(_card_gen(2024))
    assert osd_cuda.osd0.launches == before + 1
    assert int((out[:-1, 1] == 2).sum()) == nb
    assert out[-1, 0] == fails + w.osd_host(nb, dets, bel, obs)


def test_expm_takes_every_squaring_and_marks_an_overrun_on_the_card(cuda):
    """With no max_squarings every element takes the squarings it needs: 13
    in one launch on the resident route, max(s) launches on the tiled one.
    An operand over a given limit comes back NaN, not a finite wrong value
    (raising would cost a sync)."""
    from noisyquantumsimulator_tpu_torch.ops import expm as texpm
    A = torch.zeros((2, 4, 4), dtype=torch.float64, device=cuda)
    A[1, 0, 1] = 1.414e4
    ref = texpm.expm(A.cpu(), method="taylor16")
    before = fused_masked_squaring.launches
    got = texpm.expm(A, method="taylor16")
    assert fused_masked_squaring.launches == before + 1
    assert torch.allclose(got.cpu(), ref, rtol=1e-12, atol=0.0)
    over = texpm.expm(A, max_squarings=12, method="taylor16")
    assert bool(torch.isnan(over[1]).all())
    assert torch.equal(over[0].cpu(), ref[0])
    rng = np.random.default_rng(13)
    K = torch.as_tensor(rng.standard_normal((2, 256, 256)), device=cuda)
    K = (K - K.mT) * torch.tensor([0.05, 0.6], dtype=K.dtype,
                                  device=cuda)[:, None, None]
    need = texpm._needed_squarings(K, texpm._THETA13)
    before = fused_masked_squaring.launches
    got = texpm.expm(K, method="pade13")
    assert fused_masked_squaring.launches == before + int(need.max())
    assert torch.allclose(got.cpu(), texpm.expm(K.cpu(), method="pade13"),
                          rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("which", ["readout", "cooling"])
def test_readout_and_cooling_cuda_match_cpu(cuda, which):
    from noisyquantumsimulator_tpu_torch.gate import cooling, readout
    sim = {"readout": readout.simulate_fluorescence_readout,
           "cooling": cooling.simulate_sideband_cooling}[which]
    before = fused_masked_squaring.launches
    g, c = sim(device="cuda"), sim(device="cpu")
    assert fused_masked_squaring.launches == before + (6 if which == "readout" else 1)
    for k, v in vars(c).items():
        if isinstance(v, (float, np.ndarray)):
            assert np.abs(np.asarray(vars(g)[k]) - v).max() <= 1e-12, k


def test_ms_gate_cuda_matches_cpu(cuda):
    """A small MS gate (n_fock 4: (256, 256) complex128, K2 tiled) on the
    card against the same engine on the CPU."""
    from noisyquantumsimulator_tpu_torch.gate import ms_gate
    before = fused_masked_squaring.launches
    g = ms_gate.simulate_ms_gate(n_fock=4, gh_nodes=3, device="cuda")
    assert fused_masked_squaring.launches > before
    c = ms_gate.simulate_ms_gate(n_fock=4, gh_nodes=3, device="cpu")
    assert np.abs(g.superop - c.superop).max() <= 1e-12
    assert abs(g.fidelity - c.fidelity) <= 1e-12


# --- the surface-code matchers: the card against the port's CPU path -------

@pytest.fixture(scope="module")
def surface_d5():
    """A d = 5, 5-round memory circuit at p = 4e-3, its DEM edges and 2048
    shots of detectors from the port's sampler on the CPU."""
    from noisyquantumsimulator_tpu_torch.qec.dem import build_dem, dem_to_edges
    from noisyquantumsimulator_tpu_torch.qec.fast_sampler import (
        build_fast_sampler)
    from noisyquantumsimulator_tpu_torch.qec.surface_code import (
        memory_detector_rounds, memory_z_circuit)
    circuit = memory_z_circuit(5, 5, p=4e-3)
    g = torch.Generator()
    g.manual_seed(7)
    dets = build_fast_sampler(circuit, 2048, "cpu")(g)["detectors"]
    return dict(circuit=circuit, edges=dem_to_edges(build_dem(circuit)),
                dets=dets, rounds=memory_detector_rounds(5, 5))


def _matcher(kind, s, device):
    from noisyquantumsimulator_tpu_torch.qec import (cluster_matcher as cm,
                                                     decoders, exact_matcher
                                                     as em, window_matcher as wm)
    n = s["circuit"].n_detectors
    e, p, o = s["edges"]
    if kind == "greedy":
        return decoders.MatchingDecoder(n, e, p, o, max_defects=16,
                                        device=device)
    if kind == "exact":
        return em.ExactMatcher(n, e, p, o, max_defects=8, chunk=512,
                               device=device)
    if kind == "hybrid":
        return em.HybridMatcher(n, e, p, o, max_defects=6, greedy_defects=16,
                                chunk=512, device=device)
    if kind == "tiered":
        return em.TieredMatcher(n, e, p, o, k_light=4, k_heavy=10, chunk=512,
                                heavy_capacity=48, device=device)
    if kind == "window":
        return wm.WindowMatcher(n, e, p, o, s["rounds"], window_rounds=3,
                                commit_rounds=1, max_defects=8, k_light=4,
                                heavy_capacity=64, greedy_fallback=12,
                                greedy_capacity=32, chunk=512, device=device)
    return cm.ClusterMatcher(n, e, p, o, max_slots=12, chunk=512,
                             tiers=((3, 4, 4, 0.05), (5, 8, 8, 0.02)),
                             cand_per_shot=3, device=device)


@pytest.mark.parametrize("kind", ["greedy", "exact", "hybrid", "tiered",
                                  "window", "cluster"])
def test_surface_matchers_cuda_match_cpu(cuda, surface_d5, kind):
    g, c = _matcher(kind, surface_d5, cuda), _matcher(kind, surface_d5, "cpu")
    dets = surface_d5["dets"]
    for s0 in range(0, dets.shape[0], 512):
        rows = dets[s0:s0 + 512]
        if kind in ("window", "cluster"):
            (pg, fg), (pc, fc) = (g.decode_device_with_overflow(rows.to(cuda)),
                                  c.decode_device_with_overflow(rows))
            assert torch.equal(fg.cpu(), fc)
        else:
            pg, pc = g.decode_device(rows.to(cuda)), c.decode_device(rows)
        assert torch.equal(pg.cpu(), pc)
    if kind == "exact":
        for a, b in zip(g.match_device(dets.to(cuda)), c.match_device(dets)):
            assert torch.equal(a.cpu(), b)


def test_stable_heavy_selection_with_ties_cuda(cuda, surface_d5):
    """Tied defect counts: the heavy rows are the most-defect rows, ties to
    the lower index, on the card as on the CPU (and as numpy's stable
    sort); a starved capacity leaves the same rows truncated."""
    from noisyquantumsimulator_tpu_torch.qec.decoders import stable_top_rows
    rng = np.random.default_rng(5)
    nd = rng.integers(0, 4, 5000)
    want = np.argsort(-nd, kind="stable")[:700]
    got = stable_top_rows(torch.as_tensor(nd, device=cuda), 700).cpu().numpy()
    assert np.array_equal(got, want)
    dets = surface_d5["dets"]
    g, c = _matcher("tiered", surface_d5, cuda), _matcher("tiered", surface_d5,
                                                          "cpu")
    assert torch.equal(g.exact_rows(dets.to(cuda)).cpu(), c.exact_rows(dets))
    assert not bool(c.exact_rows(dets).all())       # the capacity binds
    assert torch.equal(g.decode_device(dets.to(cuda)).cpu(),
                       c.decode_device(dets))


def test_surface_sampler_rates_match_dem_cuda(cuda):
    from noisyquantumsimulator_tpu_torch.qec.dem import build_dem
    from noisyquantumsimulator_tpu_torch.qec.fast_sampler import (
        build_fast_sampler)
    from noisyquantumsimulator_tpu_torch.qec.surface_code import (
        memory_z_circuit)
    circuit = memory_z_circuit(5, 5, p=2e-3)
    q = np.ones(circuit.n_detectors)
    for m in build_dem(circuit).merged().mechanisms:
        for det in m.detectors:
            q[det] *= 1.0 - 2.0 * m.probability
    rate = (1.0 - q) / 2.0
    N = 1 << 18
    g = torch.Generator(device=cuda)
    g.manual_seed(3)
    emp = (build_fast_sampler(circuit, N, cuda)(g)["detectors"]
           .sum(dim=0, dtype=torch.int64).cpu().numpy() / N)
    assert (np.abs(emp - rate) / np.sqrt(rate * (1 - rate) / N)).max() <= 5.0


# --- the sampler kernel: the op route over the same draws, the DEM ---------

def _sampler_circuit(name):
    from noisyquantumsimulator_tpu_torch.qec.ldpc import bb_memory_circuit, gross_code
    from noisyquantumsimulator_tpu_torch.qec.surface_code import memory_z_circuit
    from test_torch_fast_sampler import every_kind_circuit
    return {"gross": lambda: bb_memory_circuit(*gross_code(), 3, 1e-3),
            "surface7": lambda: memory_z_circuit(7, 7, p=1e-3),
            "every_kind": every_kind_circuit}[name]()


@pytest.mark.parametrize("name", ["gross", "surface7", "every_kind"])
def test_sampler_kernel_bit_exact_vs_op_route_on_given_draws(cuda, name):
    """Fed the op route's own uniforms and erasure bits, the kernel gives
    its detectors, observables and heralds bit for bit: the gross code (3
    rounds, p = 1e-3), d = 7 (p = 1e-3), and a circuit with every site kind
    (Bernoulli, DEPOLARIZE1, DEPOLARIZE2, PAULI_CHANNEL_2, ERASE) at p = 2e-2."""
    from noisyquantumsimulator_tpu_torch.qec import sampler_cuda
    from noisyquantumsimulator_tpu_torch.qec.fast_sampler import build_fast_sampler
    s = build_fast_sampler(_sampler_circuit(name), 4096, cuda)
    u, ebits = s.draws(_card_gen(41))
    want = s.op_route(u, ebits)
    before = sampler_cuda.walk.launches
    got = sampler_cuda.walk(s.device_table, 4096, draws=(u, ebits))
    torch.cuda.synchronize()
    assert sampler_cuda.walk.launches == before + 1
    for g, key in zip(got, ("detectors", "observables", "heralds")):
        assert torch.equal(g, want[key]), key
    assert want["detectors"].any()
    if name == "every_kind":
        assert want["heralds"].any() and all(s.table["counts"])


@pytest.mark.parametrize("name", ["gross", "every_kind"])
def test_sampler_kernel_draws_the_stated_philox_stream(cuda, name):
    """From a generator the kernel draws Philox4x32-10 under the key that
    its first draw on the card gives, at counter (draw / 4, shot): its
    shots equal a numpy walk of the table over those draws."""
    from noisyquantumsimulator_tpu_torch.qec.fast_sampler import build_fast_sampler
    from test_torch_fast_sampler import numpy_walk, philox_draws
    s = build_fast_sampler(_sampler_circuit(name), 2048, cuda)
    key = torch.empty(2, dtype=torch.int64, device=cuda).random_(
        0, 1 << 32, generator=_card_gen(77)).cpu().numpy()
    got = s(_card_gen(77))
    want = numpy_walk(s.table, *philox_draws(s.table, 2048, key))
    for g, w in zip((got["detectors"], got["observables"], got["heralds"]), want):
        assert np.array_equal(g.cpu().numpy(), w)
    assert got["detectors"].any()


def test_sampler_kernel_draws_by_seed_and_not_by_layout(cuda):
    """One seed gives the same shots twice, another seed other shots; the
    first 4096 rows at 2^18 shots a call (one thread a shot, 256 a block)
    equal those at 4096 shots a call (8 threads a shot, 32 shots a block)."""
    from noisyquantumsimulator_tpu_torch.qec import sampler_cuda
    from noisyquantumsimulator_tpu_torch.qec.fast_sampler import build_fast_sampler
    circuit = _sampler_circuit("gross")
    small, big = (build_fast_sampler(circuit, n, cuda) for n in (4096, 1 << 18))
    assert sampler_cuda.layout(300, 2088, 4096)[:2] == (32, 8)
    assert sampler_cuda.layout(300, 2088, 1 << 18)[:2] == (256, 1)
    a, b, c = small(_card_gen(8)), small(_card_gen(8)), small(_card_gen(9))
    for key in a:
        assert torch.equal(a[key], b[key])
    assert not torch.equal(a["detectors"], c["detectors"])
    wide = big(_card_gen(8))
    for key in a:
        assert torch.equal(wide[key][:4096], a[key])


def test_gross_sampler_rates_and_pairs_match_dem_cuda(cuda):
    """The kernel's gross-code shots (3 rounds, p = 1e-3, N = 2^18) fire each
    detector and observable, and each pair of detectors that share a
    mechanism, at the DEM's exact rates within 5 binomial sigma (counts of
    variance >= 25, as the benchmark's `rate_z`)."""
    from noisyquantumsimulator_tpu_torch.qec.dem import build_dem
    from noisyquantumsimulator_tpu_torch.qec.fast_sampler import build_fast_sampler
    circuit = _sampler_circuit("gross")
    mechs = build_dem(circuit).merged().mechanisms
    n_det, n_obs = circuit.n_detectors, circuit.n_observables
    H = np.zeros((n_det + n_obs, len(mechs)), np.int64)
    for j, m in enumerate(mechs):
        H[list(m.detectors), j] = 1
        H[[n_det + o for o in range(n_obs) if m.observables >> o & 1], j] = 1
    lf = np.log(np.abs(1.0 - 2.0 * np.array([m.probability for m in mechs])))
    e1 = np.exp(H @ lf)                                   # E[(-1)^x] of each column
    rate = (1.0 - e1) / 2.0
    a, b = np.nonzero(np.triu(H[:n_det] @ H[:n_det].T, 1))
    e_ab = np.exp(((H[a] ^ H[b]) * lf).sum(axis=1))       # E[(-1)^(x_a + x_b)]
    both = (1.0 - e1[a] - e1[b] + e_ab) / 4.0
    N = 1 << 18
    o = build_fast_sampler(circuit, N, cuda)(_card_gen(5))
    x = torch.cat([o["detectors"], o["observables"]], dim=1).to(torch.float32)
    fired = x.sum(dim=0).cpu().numpy()
    pairs = (x[:, :n_det].T @ x[:, :n_det]).cpu().numpy()[a, b]
    count = np.concatenate([fired, pairs])
    prob = np.concatenate([rate, both])
    var = N * prob * (1 - prob)
    keep = var >= 25
    assert keep.sum() > 3000
    z = (count[keep] - N * prob[keep]) / np.sqrt(var[keep])
    assert np.abs(z).max() <= 5.0


def test_bench_steps_launch_the_sampler_kernel_once(cuda, gross_rep):
    """Each `bench_bb` step and each `bench_qec` step samples in exactly one
    launch of the sampler kernel."""
    from noisyquantumsimulator_tpu_torch import bench_qec
    from noisyquantumsimulator_tpu_torch.qec import sampler_cuda
    w = gross_rep[0]
    for seed in (3, 4):
        before = sampler_cuda.walk.launches
        w.step(_card_gen(seed))
        assert sampler_cuda.walk.launches == before + 1
    q = bench_qec.build_qec_workload(7, 7, 1e-3, 16384, cuda)
    for seed in (3, 4):
        before = sampler_cuda.walk.launches
        q.step(_card_gen(seed))
        assert sampler_cuda.walk.launches == before + 1


# --- the architecture loop: helpers shared with the CPU tests --------------

# the four CX layers of one round of extraction, as (dx, dy) from each
# ancilla to its data qubit; X ancillas (controls) before Z ancillas
# (targets) in every layer
EXTRACTION_LAYERS = ((-1, -1), (1, -1), (-1, 1), (1, 1))


def extraction_gates(d, rounds):
    """The rotated surface code's CX-based syndrome extraction as compiler
    `Gate`s: per round, H on the X ancillas, the four CX layers, H again
    (d = 5, 5 rounds: 49 qubits, 520 gates)."""
    from noisyquantumsimulator_tpu_torch.qec.compiler import Gate
    from noisyquantumsimulator_tpu_torch.qec.surface_code import build_layout
    lay = build_layout(d)
    xanc, zanc = sorted(lay.x_anc), sorted(lay.z_anc)
    hs = [Gate("h", (lay.x_anc[a],)) for a in xanc]
    out = []
    for _ in range(rounds):
        out += hs
        for dx, dy in EXTRACTION_LAYERS:
            out += [Gate("cx", (lay.x_anc[a], lay.data[(a[0] + dx, a[1] + dy)]))
                    for a in xanc if (a[0] + dx, a[1] + dy) in lay.data]
            out += [Gate("cx", (lay.data[(a[0] + dx, a[1] + dy)], lay.z_anc[a]))
                    for a in zanc if (a[0] + dx, a[1] + dy) in lay.data]
        out += hs
    return out


def exact_frame_rates(circuit):
    """Each qubit's exact X- and Z-frame rates at the end of an errors-only
    circuit: the frame bit is the XOR of independent channel draws, so its
    rate is (1 - prod(1 - 2 q_i)) / 2 over the channels that touch the qubit,
    q_i the channel's marginal probability of flipping that bit (X or Y on
    the qubit for the X frame, Z or Y for the Z frame). MR clears both."""
    n = circuit.n_qubits
    keep = {"x": np.ones(n), "z": np.ones(n)}

    def hit(q, px, pz):
        keep["x"][q] *= 1.0 - 2.0 * px
        keep["z"][q] *= 1.0 - 2.0 * pz

    for ins in circuit.instructions:
        p = ins.arg or 0.0
        for t in np.asarray(ins.targets):
            if ins.name == "X_ERROR":
                hit(t, p, 0.0)
            elif ins.name == "Z_ERROR":
                hit(t, 0.0, p)
            elif ins.name == "DEPOLARIZE1":
                hit(t, 2 * p / 3, 2 * p / 3)
            elif ins.name == "ERASE":
                hit(t, p / 2, p / 2)
            elif ins.name == "DEPOLARIZE2":
                hit(t[0], 8 * p / 15, 8 * p / 15)
                hit(t[1], 8 * p / 15, 8 * p / 15)
            elif ins.name == "PAULI_CHANNEL_2":
                pa, pb = np.divmod(np.arange(16), 4)
                pr = np.asarray(ins.probs, np.float64)
                for q, k in ((t[0], pa), (t[1], pb)):
                    hit(q, pr[(k == 1) | (k == 2)].sum(),
                        pr[(k == 2) | (k == 3)].sum())
            elif ins.name == "MR":
                keep["x"][t] = keep["z"][t] = 1.0
    return (1.0 - keep["x"]) / 2.0, (1.0 - keep["z"]) / 2.0


def frame_rate_z(result, circuit):
    """max |z| of the executed per-qubit flip and phase rates against the
    exact marginals (binomial sigma; rates that are exactly 0 must be 0)."""
    worst = 0.0
    for got, want in zip((result.per_qubit_flip_rate,
                          result.per_qubit_phase_rate),
                         exact_frame_rates(circuit)):
        sd = np.sqrt(want * (1 - want) / result.shots)
        assert np.all(got[sd == 0] == want[sd == 0])
        if (sd > 0).any():
            worst = max(worst, float((np.abs(got - want)[sd > 0]
                                      / sd[sd > 0]).max()))
    return worst


# --- the architecture loop on the card --------------------------------------

def test_masked_squaring_kernel_cavity_shape(cuda):
    """K2 at the cavity engine's shape: (1, 576) complex128, tiled, with the
    squaring count of a Liouvillian of 1-norm in the thousands."""
    from noisyquantumsimulator_tpu_torch.ops.expm import (_THETA13, _pade13,
                                                          _scale,
                                                          squarings_for)
    rng = np.random.default_rng(11)
    A = rng.standard_normal((1, 576, 576)) + 1j * rng.standard_normal(
        (1, 576, 576))
    A *= 3000.0 / np.abs(A).sum(axis=-2).max()
    ms = squarings_for(np.abs(A).sum(axis=-2).max(), "pade13")
    At = torch.as_tensor(A, device=cuda)
    As, s = _scale(At, _THETA13, ms)
    I = torch.eye(576, dtype=At.dtype, device=cuda).expand(At.shape)
    R = _pade13(As, I).contiguous()
    before = fused_masked_squaring.launches
    got = fused_masked_squaring(R, s, ms)
    assert fused_masked_squaring.launches == before + ms
    ref = _masked_squaring_plain(R, s, ms)
    torch.cuda.synchronize()
    assert int(s.max()) == ms
    assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


def test_cavity_gate_cuda_matches_cpu(cuda):
    """The cavity engine (n_fock 4: (256, 256) complex128, K2 tiled) on the
    card against the same engine on the CPU, the full budget."""
    from noisyquantumsimulator_tpu_torch.gate import cavity_gate
    before = fused_masked_squaring.launches
    g = cavity_gate.simulate_cavity_gate(n_fock=4, device="cuda")
    assert fused_masked_squaring.launches > before
    c = cavity_gate.simulate_cavity_gate(n_fock=4, device="cpu")
    assert np.abs(g.superop - c.superop).max() <= 1e-12
    assert abs(g.fidelity - c.fidelity) <= 1e-12
    for k, v in c.error_budget.items():
        assert abs(g.error_budget[k] - v) <= 1e-12, k


@pytest.mark.parametrize("platform", ["neutral_atoms", "trapped_ions",
                                      "cavity_qed"])
def test_execute_cuda_matches_exact_marginals(cuda, platform):
    from noisyquantumsimulator_tpu_torch.qec.compiler import compile_circuit
    from noisyquantumsimulator_tpu_torch.qec.executor import (
        compiled_to_error_circuit, execute)
    from noisyquantumsimulator_tpu_torch.qec.topology import grid_topology
    compiled = compile_circuit(extraction_gates(3, 2), grid_topology(5, 5),
                               platform=platform)
    kw = dict(p1=2e-3, cz_pauli_probs=None, t1=4.0, t2=1.0)
    res = execute(compiled, shots=1 << 18, seed=5, device="cuda", **kw)
    assert frame_rate_z(res, compiled_to_error_circuit(compiled, **kw)) <= 5.0
    zero = execute(compiled, shots=4096, seed=2, device="cuda",
                   cz_pauli_probs=np.eye(16)[0], p1=0.0, p_meas=0.0,
                   t1=1e9, t2=1e9)
    assert zero.p_any_error == 0.0


def test_density_matrix_cuda_matches_cpu(cuda):
    """A 7-qubit repetition-code circuit with every channel kind, on the
    card and on the CPU (complex64; summation orders differ)."""
    from noisyquantumsimulator_tpu_torch.qec.circuits import Circuit
    from noisyquantumsimulator_tpu_torch.solver.circuit_sim import (
        DensityMatrixSimulator)
    c = Circuit(n_qubits=7)
    c.append("H", [0])
    c.append("CX", np.array([[0, 2], [2, 4], [4, 6]]))
    c.append("DEPOLARIZE1", [0, 2, 4, 6], arg=0.03)
    c.append("PAULI_CHANNEL_2", np.array([[0, 2]]),
             probs=np.r_[0.9, np.full(15, 0.1 / 15)])
    c.append("DEPOLARIZE2", np.array([[4, 6]]), arg=0.02)
    for a, (d1, d2) in ((1, (0, 2)), (3, (2, 4)), (5, (4, 6))):
        c.append("CX", np.array([[d1, a], [d2, a]]))
    c.append("X_ERROR", [1, 3, 5], arg=0.01)
    c.append("MR", [1, 3, 5], arg=0.005)
    c.append("Z_ERROR", [0], arg=0.05)
    c.append("M", [0, 2, 4, 6])
    g = DensityMatrixSimulator(c, device=cuda).run()
    h = DensityMatrixSimulator(c, device="cpu").run()
    for k in ("rho", "measurement_probs"):
        assert float((g[k].cpu() - h[k]).abs().max()) <= 1e-6, k


# ---- the multi-device layer on one card, the solver leftovers, the NN decoder

@pytest.fixture(scope="module")
def nccl_one_rank():
    """A one-rank NCCL process group (the card is one device)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import os
    import tempfile
    import torch.distributed as dist
    from noisyquantumsimulator_tpu_torch.parallel import init_rank
    with tempfile.TemporaryDirectory() as tmp:
        init_rank(0, 1, os.path.join(tmp, "store"), "cuda")
        try:
            yield dist.get_backend()
        finally:
            dist.destroy_process_group()


def test_sharded_objective_one_rank_nccl(cuda, nccl_one_rank):
    """13 members over a one-rank "pop" mesh: one K2 launch a call, and the
    unsharded objective's costs and metrics exactly."""
    import warnings
    from noisyquantumsimulator_tpu_torch.optimize import engine
    from noisyquantumsimulator_tpu_torch.optimize.apparatus import (
        ApparatusConstraints)
    from noisyquantumsimulator_tpu_torch.parallel import (
        make_mesh, make_population_objective_sharded)
    assert nccl_one_rank == "nccl"
    app = ApparatusConstraints()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        problem = engine.build_fixed_problem(app, app.make_full_noise())
    rng = np.random.default_rng(0)
    pop = np.column_stack([rng.uniform(8.0, 12.0, 13), rng.uniform(0.2, 1.2, 13),
                           rng.uniform(1.0, 1.5, 13), rng.uniform(4.0, 5.5, 13),
                           rng.uniform(0.01, 0.03, 13)])
    obj = make_population_objective_sharded(
        problem, "smooth_jp", mesh=make_mesh(axis_names=("pop",)), n_steps=48)
    before = fused_masked_squaring.launches
    c, m = obj(pop)
    torch.cuda.synchronize()
    assert fused_masked_squaring.launches == before + 1
    c1, m1 = engine.make_population_objective(problem, "smooth_jp", n_steps=48)(pop)
    assert c.shape == (13,) and c.device.type == "cuda"
    assert torch.equal(c, c1) and all(torch.equal(m[k], m1[k]) for k in m1)


def test_dryrun_multichip_one_rank_cuda(cuda, nccl_one_rank):
    from noisyquantumsimulator_tpu_torch.graft_entry import dryrun_multichip
    before = fused_masked_squaring.launches
    r = dryrun_multichip(1)
    assert fused_masked_squaring.launches == before + 5
    assert 0.9 < r["mean_F"] <= 1.0 and 0.0 < r["qec"]["detector_fraction"] < 0.5
    with pytest.raises(ValueError):
        dryrun_multichip(2)


def test_bb_rank_body_cuda_matches_cpu(cuda):
    """The same error rows on the card and on the CPU: equal per-shot
    failures and convergence, but for shots BP leaves at a tied belief."""
    from noisyquantumsimulator_tpu_torch.parallel import bb_mc
    from noisyquantumsimulator_tpu_torch.qec.ldpc import small_bb_code
    Hx, Hz = small_bb_code()
    rng = np.random.default_rng(2)
    errors = torch.as_tensor(rng.random((2048, Hz.shape[1])) < 0.02)
    g = bb_mc.rank_body(errors.to(cuda), bb_mc.bb_tables(Hx, Hz, 0.02, 30, cuda))
    c = bb_mc.rank_body(errors, bb_mc.bb_tables(Hx, Hz, 0.02, 30, "cpu"))
    assert torch.equal(g["syndrome"].cpu(), c["syndrome"])
    diff = ((g["fail"].cpu() != c["fail"]) | (g["converged"].cpu() != c["converged"]))
    for i in torch.nonzero(diff)[:, 0].tolist():
        assert float(c["belief"][i].abs().min()) < 1e-4, i


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_evolve_rhos_trajectory_cuda_matches_cpu(cuda, dtype):
    from noisyquantumsimulator_tpu_torch.graft_entry import build_small_problem
    from noisyquantumsimulator_tpu_torch.solver.propagator import (
        Schedule, evolve_rhos, evolve_rhos_trajectory)
    L0, Cp, Cm, ph, dts, rho0s, _ = build_small_problem(32, dtype=dtype)
    sched = Schedule(np.ones(32), ph, dts)
    out = {}
    for dev in (cuda, "cpu"):
        ops = [torch.as_tensor(a, device=dev) for a in (L0, Cp, Cm, rho0s)]
        before = fused_masked_squaring.launches
        out[str(dev)] = evolve_rhos_trajectory(*ops[:3], sched, ops[3]).cpu()
        if dev == cuda:
            assert fused_masked_squaring.launches == before + 1
            last = evolve_rhos(*ops[:3], sched, ops[3]).cpu()
    g, c = out[str(cuda)], out["cpu"]
    assert g.shape == (33, 5, 9, 9)
    assert float((g - c).abs().max()) <= TOL[dtype] * float(c.abs().max())
    assert float((g[-1] - last).abs().max()) <= TOL[dtype]


def test_nn_decoder_logits_cuda_matches_cpu(cuda):
    import copy
    from noisyquantumsimulator_tpu_torch.qec.fast_sampler import build_fast_sampler
    from noisyquantumsimulator_tpu_torch.qec.nn_decoder import NNDecoder
    from noisyquantumsimulator_tpu_torch.qec.surface_code import memory_z_circuit
    dec = NNDecoder(memory_z_circuit(3, 3, p=3e-3), device=cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4)
    dets = build_fast_sampler(dec.circuit, 4096, cuda)(gen)["detectors"]
    cpu = copy.deepcopy(dec).to("cpu")
    with torch.no_grad():
        g, c = dec(dets).cpu(), cpu(dets.cpu())
    assert float((g - c).abs().max()) <= 1e-5
    clear = (c.abs() > 1e-4).numpy()
    assert np.array_equal(dec.decode_batch(dets)[clear],
                          cpu.decode_batch(dets.cpu())[clear])


# ---- the platform studies

@pytest.mark.parametrize("study", ["ms_gate_engine_study",
                                   "cavity_gate_engine_study"])
def test_engine_study_cuda_matches_cpu(cuda, study, tmp_path):
    """The MS / cavity engine study at n_fock = 4 on the card and on the
    CPU: every number but the wall time within 1e-10 (the dominant Pauli
    errors by value: their labels tie to rounding), the records too, K2
    launched."""
    import importlib
    import json
    from pathlib import Path
    mod = importlib.import_module(f"noisyquantumsimulator_tpu_torch.studies.{study}")
    before = fused_masked_squaring.launches
    g = mod.run(device=cuda, n_fock=4, store_root=str(tmp_path / "card"))
    assert fused_masked_squaring.launches > before
    c = mod.run(device="cpu", n_fock=4, store_root=str(tmp_path / "cpu"))

    def close(a, b):
        json_close(a, b, 1e-10, strings=False)

    for regime, row in c["regimes"].items():
        got = g["regimes"][regime]
        skip = ("dominant_pauli_errors", "sim_wall_s")
        close({k: v for k, v in got.items() if k not in skip},
              {k: v for k, v in row.items() if k not in skip})
        close([p for _, p in got["dominant_pauli_errors"]],
              [p for _, p in row["dominant_pauli_errors"]])
        recs = [json.loads(Path(r["calibration_record"]).read_text())
                for r in (got, row)]
        close(recs[0]["error_rates"], recs[1]["error_rates"])
        close(recs[0]["superop"], recs[1]["superop"])
        close(recs[0]["pauli_error_probs"], recs[1]["pauli_error_probs"])


def test_multichip_scaling_one_nccl_rank(cuda):
    """World size 1, one NCCL rank on the card: the study's checks hold and
    the reduced counts are the rank's."""
    from noisyquantumsimulator_tpu_torch.studies import multichip_scaling
    out = multichip_scaling.run(sizes=(1,), device=cuda, shots_per_dev=4096,
                                bb_shots=512)
    (s,), (b,) = out["surface_mc"], out["bb_ldpc_mc"]
    assert out["platform"] == "cuda" and s["n_devices"] == 1
    assert s["rank_counts"] == [[s["n_detectors_fired"], s["n_obs_flips"]]]
    assert 0.0 < s["detector_fraction"] < 0.5 and b["shots"] == 512
    assert 0.0 <= b["p_logical_shot"] < 0.5
