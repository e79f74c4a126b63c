"""The sampler's draw table, the table the CUDA kernel walks, on the CPU.

The kernel (`csrc/fast_sampler.cu`) cannot run here, so these tests hold
what it reads and the algorithm it runs: the table that `build_fast_sampler`
hands it rebuilds the signature matrices exactly, its float32 thresholds
are those the op route compares with, and a numpy walk of the table over
the op route's own uniforms, the kernel's algorithm step for step, gives
the op route's detectors, observables and heralds bit for bit. The card
tests (`test_torch_cuda.py`) hold the kernel to the op route the same way.
"""
import numpy as np
import pytest
import torch

from noisyquantumsimulator_tpu_torch.qec import sampler_cuda
from noisyquantumsimulator_tpu_torch.qec.circuits import Instruction
from noisyquantumsimulator_tpu_torch.qec.fast_sampler import build_fast_sampler
from noisyquantumsimulator_tpu_torch.qec.ldpc import bb_memory_circuit, gross_code
from noisyquantumsimulator_tpu_torch.qec.surface_code import memory_z_circuit

torch.set_num_threads(1)

BERN, DEP1, DEP2, PAIR, ERASE = range(5)


def every_kind_circuit(d=3, rounds=3, p=2e-2):
    """A surface-code memory circuit with a site of every kind the sampler
    builds: X_ERROR and measurement flips (Bernoulli), DEPOLARIZE1 on idle
    data, calibrated PAULI_CHANNEL_2 after the CX layers, every other layer
    DEPOLARIZE2 instead, and ERASE on the data each round."""
    probs = np.zeros(16)
    probs[1:] = np.linspace(1.0, 3.0, 15)
    probs *= p / probs.sum()
    probs[0] = 1.0 - p
    c = memory_z_circuit(d, rounds, noise="calibrated", p=p, cz_pauli_probs=probs,
                         p_erase=p)
    pairs = [i for i, ins in enumerate(c.instructions) if ins.name == "PAULI_CHANNEL_2"]
    for i in pairs[::2]:
        c.instructions[i] = Instruction("DEPOLARIZE2", c.instructions[i].targets, p)
    return c


CIRCUITS = {
    "gross": lambda: bb_memory_circuit(*gross_code(), 3, 1e-3),
    "surface5": lambda: memory_z_circuit(5, 5, p=1e-3),
    "every_kind": every_kind_circuit,
}


@pytest.fixture(scope="module", params=list(CIRCUITS))
def built(request):
    circuit = CIRCUITS[request.param]()
    return request.param, circuit, build_fast_sampler(circuit, 256, "cpu")


def _fields(table):
    rec = table["rec"]
    return (rec[:, 0] & 7, rec[:, 0] >> 3, rec[:, 1].view(np.float32),
            rec[:, 2], rec[:, 3].view(np.float32))


def test_table_signatures_rebuild_the_signature_matrices(built):
    """The CSR signatures of the table's fault bits are the rows of Fd and
    Fo in the op route's order, exactly; each draw's bits lie where its
    kind and stride say."""
    name, _, s = built
    t = s.table
    n_bits, n_det = len(s.order), t["n_det"]
    dense = np.zeros((n_bits, n_det + t["n_obs"]), np.int8)
    rows = np.repeat(np.arange(n_bits), np.diff(t["sig_ptr"]))
    dense[rows, t["sig_col"]] = 1
    assert np.array_equal(dense[:, :n_det], s.Fd[s.order])
    assert np.array_equal(dense[:, n_det:], s.Fo[s.order])
    assert sorted(s.order) == list(range(len(s.faults)))
    kind, b0, _, _, _ = _fields(t)
    bits = {BERN: 1, DEP1: 2, DEP2: 4, PAIR: 4, ERASE: 2}
    owned = np.concatenate([b0[kind == k][:, None] + t["strides"][k] * np.arange(bits[k])
                            for k in range(5) if (kind == k).any()], axis=None)
    assert sorted(owned) == list(range(n_bits))
    assert np.all(np.diff(kind) >= 0)          # the op route's draw order
    assert tuple(np.bincount(kind, minlength=5)) == t["counts"]
    if name == "every_kind":
        assert all(t["counts"])
    if name == "gross":
        assert t["counts"] == (360, 432, 1296, 0, 0) and len(s.order) == 6408
        assert np.diff(t["sig_ptr"]).max() <= 3 + 12


def test_table_thresholds_are_the_op_routes(built):
    """float32 thresholds as torch computes them on the host from each
    site's probability: p, 2p/3 and p/3 for DEPOLARIZE1, the cumulative
    table's last entry for PAULI_CHANNEL_2."""
    _, circuit, s = built
    kind, _, t, a, b = _fields(s.table)
    p = {BERN: [], DEP1: [], DEP2: [], ERASE: []}
    for ins in circuit.instructions:
        n, arg = len(ins.targets), ins.arg or 0.0
        k = {"X_ERROR": BERN, "Z_ERROR": BERN, "M": BERN, "MR": BERN, "DEPOLARIZE1": DEP1,
             "DEPOLARIZE2": DEP2, "ERASE": ERASE}.get(ins.name)
        if k is not None and arg > 0:
            p[k] += [arg] * n
    for k in (BERN, DEP1, DEP2, ERASE):
        pk = torch.tensor(p[k], dtype=torch.float32)      # the circuit's order
        assert np.array_equal(t[kind == k], pk.numpy())
        if k == DEP1:
            assert np.array_equal(a[kind == k].view(np.float32),
                                  (2.0 * pk / 3.0).numpy())
            assert np.array_equal(b[kind == k], (pk / 3.0).numpy())
    cum = s.table["cum"]
    assert np.array_equal(t[kind == PAIR], cum[:, -1]) and np.all(np.diff(cum, axis=1) >= 0)
    assert np.array_equal(a[kind == PAIR], np.arange((kind == PAIR).sum()))
    assert np.array_equal(a[kind == ERASE], np.arange((kind == ERASE).sum()))


def numpy_walk(table, u, ebits):
    """The kernel's walk over given draws, in numpy: for each draw the
    shots below its threshold, then the bits its kind sets, each bit's
    signature XORed into the shot's row of [dets | obs | heralds]."""
    kind, b0, t, a, b = _fields(table)
    n_det, n_obs, ne = table["n_det"], table["n_obs"], table["n_erase"]
    ptr, col, st, cum = table["sig_ptr"], table["sig_col"], table["strides"], table["cum"]
    acc = np.zeros((u.shape[0], n_det + n_obs + ne), np.uint8)

    def flip(rows, bit):
        if rows.size:
            acc[np.ix_(rows, col[ptr[bit]:ptr[bit + 1]])] ^= 1

    def pauli_pair(rows, o, base, stride):
        pa, pb = o >> 2, o & 3
        flip(rows[(pa == 1) | (pa == 2)], base)
        flip(rows[pa >= 2], base + stride)
        flip(rows[(pb == 1) | (pb == 2)], base + 2 * stride)
        flip(rows[pb >= 2], base + 3 * stride)

    for d in range(len(kind)):
        rows = np.flatnonzero(u[:, d] < t[d])
        if not rows.size:
            continue
        uh, k = u[rows, d], kind[d]
        if k == BERN:
            flip(rows, b0[d])
        elif k == DEP1:
            flip(rows[uh < a[d:d + 1].view(np.float32)[0]], b0[d])
            flip(rows[uh >= b[d]], b0[d] + st[DEP1])
        elif k == DEP2:
            q = (uh / t[d]) * np.float32(15.0)
            pauli_pair(rows, np.minimum(np.floor(q).astype(np.int64) + 1, 15), b0[d], st[DEP2])
        elif k == PAIR:
            o = 1 + (uh[:, None] >= cum[a[d]][None]).sum(axis=1)
            pauli_pair(rows, o, b0[d], st[PAIR])
        else:
            acc[rows, n_det + n_obs + a[d]] ^= 1
            flip(rows[ebits[rows, a[d], 0] > 0], b0[d])
            flip(rows[ebits[rows, a[d], 1] > 0], b0[d] + st[ERASE])
    return acc[:, :n_det], acc[:, n_det:n_det + n_obs], acc[:, n_det + n_obs:]


_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 (Salmon et al., SC'11) over arrays of counters: the
    kernel's generator, in numpy."""
    m = np.uint64(0xFFFFFFFF)
    c0, c1, c2, c3 = (np.asarray(c, np.uint64) & m for c in (c0, c1, c2, c3))
    k0, k1 = np.uint64(k0) & m, np.uint64(k1) & m
    for _ in range(10):
        p0, p1 = np.uint64(_PHILOX_M[0]) * c0, np.uint64(_PHILOX_M[1]) * c2
        c0, c1, c2, c3 = (((p1 >> np.uint64(32)) ^ c1 ^ k0) & m, p1 & m,
                          ((p0 >> np.uint64(32)) ^ c3 ^ k1) & m, p0 & m)
        k0, k1 = (k0 + np.uint64(_PHILOX_W[0])) & m, (k1 + np.uint64(_PHILOX_W[1])) & m
    return c0, c1, c2, c3


def philox_draws(table, shots, key):
    """The kernel's draws under `key` (two words): draw d of shot s is word
    d % 4 of Philox at counter (d / 4, s, 0, 0); u is its high 24 bits
    times 2^-24, an erasure's x and z bits its bits 0 and 1."""
    n_draws, ne = table["rec"].shape[0], table["n_erase"]
    groups = -(-n_draws // 4)
    g, s = np.meshgrid(np.arange(groups), np.arange(shots))
    zero = np.zeros_like(g)
    words = np.stack(philox4x32_10(g, s, zero, zero, *key), axis=-1)
    words = words.reshape(shots, 4 * groups)[:, :n_draws].astype(np.uint32)
    u = (words >> 8).astype(np.float32) * np.float32(2.0 ** -24)
    e = words[:, n_draws - ne:]
    return u, np.stack([e & 1, (e >> 1) & 1], axis=-1).astype(np.uint8)


def test_philox_reference_gives_the_known_answers():
    """Random123's known-answer vectors of Philox4x32-10."""
    got = philox4x32_10(0, 0, 0, 0, 0, 0)
    assert [int(x) for x in got] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    got = philox4x32_10(0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF)
    assert [int(x) for x in got] == [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    got = philox4x32_10(0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344, 0xA4093822, 0x299F31D0)
    assert [int(x) for x in got] == [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]


def test_numpy_walk_of_the_table_is_the_op_route(built):
    """Over the op route's own uniforms the table's walk gives its
    detectors, observables and heralds bit for bit, and the CPU sample is
    the op route over those draws."""
    name, _, s = built
    g = torch.Generator()
    g.manual_seed(19)
    u, ebits = s.draws(g)
    assert u.shape == (256, s.table["rec"].shape[0]) and u.dtype == torch.float32
    want = s.op_route(u, ebits)
    dets, obs, heralds = numpy_walk(s.table, u.numpy(), ebits.numpy())
    assert np.array_equal(dets, want["detectors"].numpy())
    assert np.array_equal(obs, want["observables"].numpy())
    assert np.array_equal(heralds, want["heralds"].numpy())
    assert want["detectors"].any()
    if name == "every_kind":
        assert want["heralds"].any()
    g.manual_seed(19)
    got = s(g)
    for key in ("detectors", "observables", "heralds"):
        assert torch.equal(got[key], want[key])


def test_op_route_draws_one_uniform_a_site_then_the_erasure_bits():
    """The op route draws, in order, one block of uniforms a kind and then
    the erasures' bits: the stream torch.rand and torch.randint give."""
    s = build_fast_sampler(every_kind_circuit(), 7, "cpu")
    g = torch.Generator()
    g.manual_seed(4)
    u, ebits = s.draws(g)
    g.manual_seed(4)
    parts = [torch.rand((7, n), generator=g) for n in s.table["counts"] if n]
    bits = torch.randint(0, 2, (7, s.table["n_erase"], 2), generator=g, dtype=torch.uint8)
    assert torch.equal(u, torch.cat(parts, dim=1)) and torch.equal(ebits, bits)


def test_cpu_sample_is_the_earlier_formulation(built):
    """The CPU sample equals the sampler's formulation before the draw table,
    inlined: a block of torch.rand a kind, PAULI_CHANNEL_2's as (shots, n,
    1), the thresholds computed with torch ops from each site's float32
    probability (2p/3, p/3, the 15-outcome index map), then the erasures'
    bits, and one 0/1 float32 product with the signature rows. So the
    stream and the float32 thresholds that the table precomputes on the host
    are those the CPU route always drew and compared with."""
    _, _, s = built
    shots = 256
    kind, _, t, _, _ = _fields(s.table)
    nb, n1, nd2, n2, ne = s.table["counts"]
    p = {k: torch.as_tensor(t[kind == k]) for k in (BERN, DEP1, DEP2, ERASE)}
    cum = torch.as_tensor(np.asarray(s.table["cum"], np.float32).reshape(-1, 15))
    g = torch.Generator()
    g.manual_seed(23)
    blocks = []

    def pair_bits(idx):
        pa, pb = idx // 4, idx % 4
        blocks.extend([(pa == 1) | (pa == 2), (pa == 2) | (pa == 3),
                       (pb == 1) | (pb == 2), (pb == 2) | (pb == 3)])

    if nb:
        blocks.append(torch.rand((shots, nb), generator=g) < p[BERN])
    if n1:
        u = torch.rand((shots, n1), generator=g)
        blocks.append(u < 2.0 * p[DEP1] / 3.0)
        blocks.append((u >= p[DEP1] / 3.0) & (u < p[DEP1]))
    if nd2:
        u = torch.rand((shots, nd2), generator=g)
        idx = torch.floor(u / p[DEP2].clamp_min(1e-30) * 15.0).to(torch.int32) + 1
        pair_bits(torch.where(u < p[DEP2], idx.clamp_max(15), 0))
    if n2:
        u = torch.rand((shots, n2, 1), generator=g)
        idx = (u >= cum[None]).sum(dim=-1, dtype=torch.int32)
        pair_bits(torch.where(u[..., 0] < cum[:, -1], idx + 1, 0))
    heralds = torch.zeros((shots, ne), dtype=torch.uint8)
    if ne:
        u = torch.rand((shots, ne), generator=g)
        bits = torch.randint(0, 2, (shots, ne, 2), generator=g, dtype=torch.uint8)
        hit = u < p[ERASE]
        heralds = hit.to(torch.uint8)
        blocks += [hit & (bits[..., 0] > 0), hit & (bits[..., 1] > 0)]
    F = torch.as_tensor(np.concatenate([s.Fd, s.Fo], axis=1)[s.order], dtype=torch.float32)
    parity = (torch.cat(blocks, dim=1).to(torch.float32) @ F).to(torch.int32) & 1
    n_det = s.Fd.shape[1]
    g.manual_seed(23)
    got = s(g)
    assert torch.equal(got["detectors"], parity[:, :n_det].to(torch.uint8))
    assert torch.equal(got["observables"], parity[:, n_det:].to(torch.uint8))
    assert torch.equal(got["heralds"], heralds)
    assert got["detectors"].any()


@pytest.mark.parametrize("n_out,n_draws,shots,want", [
    (300, 2088, 65536, (64, 4, 524)),       # bb-gross's step
    (193, 2576, 131072, (128, 2, 1288)),    # surface-d7's step
    (193, 2576, 1 << 20, (256, 1, 2576)),   # bench_qec's throughput block
    (300, 2088, 256, (32, 8, 264)),         # few shots: 8 threads a shot
    (24, 200, 1024, (256, 1, 200)),         # too few draws to split
    (40000, 9000, 4096, (32, 8, 1128)),     # wide bitsets: one warp a block
])
def test_layout_follows_the_input(n_out, n_draws, shots, want):
    assert sampler_cuda.layout(n_out, n_draws, shots) == want


def test_layout_raises_where_one_warps_bitsets_do_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        sampler_cuda.layout(32 * 2000, 100, 64)


def test_kernel_wrapper_takes_only_the_card():
    s = build_fast_sampler(memory_z_circuit(3, 2, p=1e-3), 8, "cpu")
    assert s.device_table is None
    tab = sampler_cuda.tables(s.table, "cpu")
    g = torch.Generator()
    with pytest.raises(ValueError, match="not a CUDA device"):
        sampler_cuda.walk(tab, 8, generator=g)
