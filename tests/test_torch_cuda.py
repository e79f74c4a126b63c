"""The port's CUDA kernels against their plain twins, on the card only.

Marked `cuda`; each test skips where torch sees no CUDA device. This file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: float32 1e-4 and complex64 1e-5 relative to max|twin| (the
kernels and the library products sum in different orders; K1's float32
product is the 3xTF32 split on the tensor cores); float64 and
complex128 1e-12. The min-sum c2v kernel K3 is bit-exact against its twin
at float32 and bfloat16 (one rounding of the same exact product). The
surface-code matchers (plain torch ops, no kernel of their own) are
bit-identical on the card and on the CPU; the fast sampler's detector rates
lie within 5 binomial sigma of the DEM's analytic rates. The architecture
loop's executor (torch ops) gives per-qubit frame rates within 5 binomial
sigma of their exact marginals (`exact_frame_rates`, shared with the CPU
tests); the density-matrix simulator on the card equals the CPU's to 1e-6.
"""
import numpy as np
import pytest
import torch

from noisyquantumsimulator_tpu_torch.qec import bp_cuda
from noisyquantumsimulator_tpu_torch.ops.expm_cuda import (
    _masked_squaring_plain, fused_masked_squaring)
from noisyquantumsimulator_tpu_torch.solver.scan_cuda import (
    _evolve_real_phased_many_plain, evolve_real_phased_many_cuda)

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
    before = bp_cuda.c2v.launches
    pg, bg, _ = dg._full(dets)
    assert bp_cuda.c2v.launches == before + 7 + 38
    pc, bc, _ = dc._full(dets.cpu())
    assert torch.equal(bg.cpu(), bc)
    assert float((pg.cpu() == pc)[~bc].float().mean()) >= 0.999


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
