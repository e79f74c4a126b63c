"""OSD-0 on the card (`qec/osd_cuda`): its constants, its twin and the
kernel's algorithm, on the CPU.

The kernel (`csrc/osd0.cu`) runs only on the card, where
`tests/test_torch_cuda.py` holds it to the twin bit for bit. Here:

  - `gf2_rank` against a plain elimination over Python integers, and the
    packed H against H;
  - `osd0` on CPU tensors is the host C++ OSD-0 (`native.osd0_batch_native`)
    and reads its observable flips and failures off the estimate; on
    syndromes that H can produce the estimate is the JAX package's `_osd0`;
  - the kernel's algorithm written out in numpy (`_kernel_walk`: keys
    ordered as integers with -0.0 taken as +0.0, the C++ list of unused
    rows, the stop at rank(H) pivots) equals the C++ bit for bit, on
    syndromes H cannot produce too, where the row choice matters (the JAX
    package's row swaps give other estimates there).
"""
import numpy as np
import pytest
import torch

from noisyquantumsimulator_tpu.qec import ldpc as jl
from noisyquantumsimulator_tpu_torch.qec import ldpc as tl
from noisyquantumsimulator_tpu_torch.qec import osd_cuda
from noisyquantumsimulator_tpu_torch.qec.dem_decoder import dem_arrays
from noisyquantumsimulator_tpu_torch.qec.native import osd0_batch_native

torch.set_num_threads(1)

K = 12


@pytest.fixture(scope="module")
def dem():
    """The small BB code's DEM (2 rounds, p = 1e-3): H (108, 657), rank 102,
    its observable masks and their tables; 16 syndromes of random faults,
    4 random ones H cannot produce, one all-zero; beliefs with ties and
    signed zeros."""
    H, obs_mask, _ = dem_arrays(tl.bb_memory_circuit(*tl.small_bb_code(), 2, 1e-3))
    rng = np.random.default_rng(7)
    m, n = H.shape
    err = (rng.random((16, n)) < 0.01).astype(np.int64)
    dets = np.concatenate([(err @ H.T.astype(np.int64)) % 2, rng.integers(0, 2, (4, m)),
                           np.zeros((1, m), np.int64)]).astype(np.uint8)
    bel = rng.normal(size=(len(dets), n)).astype(np.float32)
    bel[:4, :300] = np.round(bel[:4, :300])           # ties, -0.0 among them
    bel[4, ::5], bel[4, 2::5] = -0.0, 0.0
    obs = rng.integers(0, 2, (len(dets), K)).astype(np.int32)
    return {"H": H, "obs_mask": obs_mask, "tab": osd_cuda.tables(H, obs_mask, K, "cpu"),
            "dets": dets, "bel": bel, "obs": obs, "consistent": 16}


def _rank_plain(H):
    rows = [int("".join(map(str, r[::-1])), 2) for r in np.asarray(H, np.uint8) & 1]
    rank = 0
    while rows:
        piv = rows.pop()
        if piv:
            low = piv & -piv
            rows = [r ^ piv if r & low else r for r in rows]
            rank += 1
    return rank


def test_gf2_rank_and_packing(dem):
    rng = np.random.default_rng(3)
    for M in (rng.integers(0, 2, (30, 70)), np.eye(9, dtype=np.uint8),
              np.tile(rng.integers(0, 2, (5, 20)), (3, 1)), np.zeros((4, 6))):
        assert osd_cuda.gf2_rank(M) == _rank_plain(M)
    tab = dem["tab"]
    assert (tab["m"], tab["n"], tab["rank"]) == (108, 657, _rank_plain(dem["H"])) \
        and tab["rank"] == 102
    words = tab["Hp"].numpy()
    assert words.shape == (108, (657 + 64) // 64)
    bits = np.unpackbits(words.view(np.uint8), axis=1, bitorder="little")
    assert np.array_equal(bits[:, :657], dem["H"]) and not bits[:, 657:].any()


def test_osd0_on_the_cpu_is_the_native_twin(dem):
    """est is osd0_batch_native's; pred its observable flips, fail where they
    miss obs; on the syndromes H produces, est is also the JAX `_osd0`'s."""
    est, pred, fail = osd_cuda.osd0(dem["tab"], torch.from_numpy(dem["dets"]),
                                    torch.from_numpy(dem["bel"]), torch.from_numpy(dem["obs"]))
    want = osd0_batch_native(dem["H"], dem["dets"], dem["bel"])
    assert est.dtype == torch.uint8 and np.array_equal(est.numpy(), want)
    bits = (want.astype(np.int64) @ ((dem["obs_mask"][:, None] >> np.arange(K)) & 1)) & 1
    assert pred.dtype == torch.int64
    assert np.array_equal(pred.numpy(), (bits << np.arange(K)).sum(axis=1))
    assert fail.dtype == torch.bool
    assert np.array_equal(fail.numpy(), (bits != dem["obs"]).any(axis=1))
    c = dem["consistent"]
    ref = np.stack([jl._osd0(dem["H"], dem["dets"][i], dem["bel"][i]) for i in range(c)])
    assert np.array_equal(want[:c], ref)
    assert np.array_equal((want[:c].astype(np.int64) @ dem["H"].T) % 2, dem["dets"][:c])
    assert not want[-1].any()                         # the all-zero syndrome
    assert osd_cuda.osd0.launches == 0


def _kernel_walk(tab, det, bel):
    """csrc/osd0.cu's algorithm for one shot, in numpy: the columns in the
    order of the kernel's keys, the pivot the least (list position, row)
    among the unused rows holding the column's bit, the list updated as the
    kernel's thread 0 does, the walk stopped at rank(H) pivots. Returns the
    estimate and the columns walked."""
    m, n, none = tab["m"], tab["n"], 1 << 40
    A = tab["Hp"].numpy().view(np.uint64).copy()
    sw, sbit = n >> 6, np.uint64(1) << np.uint64(n & 63)
    A[det != 0, sw] |= sbit
    b = np.where(bel == 0.0, np.float32(0.0), bel).view(np.uint32).astype(np.uint64)
    b = np.where(b & 0x80000000, ~b & 0xffffffff, b | 0x80000000)
    order = np.sort((b << np.uint64(32)) | np.arange(n, dtype=np.uint64)) & 0xffffffff
    pos, unused, pcol = np.arange(m), list(range(m)), np.full(m, -1)
    npiv = ci = 0
    while ci < n and npiv < tab["rank"]:
        c = int(order[ci])
        ci += 1
        has = (A[:, c >> 6] >> np.uint64(c & 63)) & np.uint64(1) != 0
        best = np.where(has & (pos < none), (pos << 16) | np.arange(m), none).min()
        if best == none:
            continue
        piv, upos = best & 0xffff, best >> 16
        has[piv] = False
        A[has] ^= A[piv]
        last = unused[m - npiv - 1]
        unused[upos], pos[last], pos[piv], pcol[piv] = last, upos, none, c
        npiv += 1
    est = np.zeros(n, np.uint8)
    est[pcol[(pcol >= 0) & (A[:, sw] & sbit != 0)]] = 1
    return est, ci


def test_the_kernel_walk_is_the_twin_bit_for_bit(dem):
    """On every syndrome, H's or not, with ties and signed zeros: the
    kernel's algorithm equals the C++ OSD-0, and stops at rank(H) pivots
    well before the last column. On syndromes H cannot produce the JAX
    `_osd0` (which swaps rows) answers otherwise: the row choice matters
    there, so the kernel keeps the C++ list."""
    want = osd0_batch_native(dem["H"], dem["dets"], dem["bel"])
    walked = []
    for i, (det, bel) in enumerate(zip(dem["dets"], dem["bel"])):
        est, cols = _kernel_walk(dem["tab"], det, bel)
        assert np.array_equal(est, want[i]), i
        walked.append(cols)
    assert max(walked) < dem["tab"]["n"]
    c = dem["consistent"]
    swapped = np.stack([jl._osd0(dem["H"], dem["dets"][i], dem["bel"][i])
                        for i in range(c, c + 4)])
    assert not np.array_equal(swapped, want[c:c + 4])


def test_osd0_rejects_what_the_kernel_does_not_take(dem):
    tab = dem["tab"]
    d, b, o = (torch.from_numpy(dem[key][:3]) for key in ("dets", "bel", "obs"))
    with pytest.raises(ValueError):
        osd_cuda.osd0(tab, d[:, 1:], b, o)
    with pytest.raises(ValueError):
        osd_cuda.osd0(tab, d, b[:2], o)
    with pytest.raises(TypeError):
        osd_cuda.osd0(tab, d.to(torch.int32), b, o)
    with pytest.raises(TypeError):
        osd_cuda.osd0(tab, d, b.double(), o)
    with pytest.raises(ValueError):
        osd_cuda.osd0(tab, d.to("meta"), b.to("meta"), o.to("meta"))
    with pytest.raises(ValueError):
        osd_cuda.tables(dem["H"], dem["obs_mask"], 64, "cpu")
    assert osd_cuda.osd0.launches == 0
