"""QEC layer of the port: the BB-LDPC, surface-code and color-code memory
paths, and the architecture loop (topology -> compiler -> scheduler ->
executor).

  circuits         stabilizer-circuit IR (host numpy)
  dem              detector error model by frame propagation (host numpy)
  fast_sampler     circuit-exact detector sampler (one CUDA kernel a sample;
                   the torch op route elsewhere; explicit generator)
  pauli_frame      per-instruction Pauli-frame sampler (torch)
  surface_code     rotated surface-code layouts and memory circuits (host)
  decoders         matching graph (APSP), batched greedy, host union-find
  exact_matcher    exact matching by a bitmask DP on the device
  window_matcher   sliding-window exact matching on the device
  cluster_matcher  exact matching by cluster decomposition on the device
  memory           run_memory: sample -> decode -> logical error rate
  erasure          heralded-erasure peeling + matching
  lattice_surgery  Z (x) Z measurement by rough merge/split (host build),
                   sampled and decoded on the device
  nn_decoder       MLP decoder over detector bits, trained on the device
  ldpc             BB codes, min-sum BP (dense, edge-list, slot layout), OSD-0
  bp_cuda          the slot-layout min-sum kernels: K3 (the check-node update)
                   and v2c (the variable-node update and the beliefs), with
                   their twins
  dem_decoder      tiered BP on the DEM + host OSD-0
  osd_cuda         OSD-0 on the card, one block a shot, with the host C++
                   OSD-0 as its twin
  native           the C++ OSD-0, exact matcher and erasure peeler (built
                   with the host compiler)
  color_code       triangular 6.6.6 color codes (host), BP+OSD memory
  ldpc_layout      movement-based BB check extraction planning (host)
  topology         qubit layouts and connectivity (host)
  scheduler        ASAP / ALAP / list scheduling under constraints (host)
  compiler         decompose -> map -> route -> schedule (host)
  executor         compiled circuit -> error circuit -> frame Monte Carlo
                   on the device

Class names drop the reference's `TPU` suffix: ExactMatcherTPU ->
ExactMatcher, HybridMatcherTPU -> HybridMatcher, TieredMatcherTPU ->
TieredMatcher, WindowMatcherTPU -> WindowMatcher, ClusterMatcherTPU ->
ClusterMatcher. Function names are the reference's.
"""
from . import (bp_cuda, circuits, cluster_matcher, color_code,  # noqa: F401
               compiler, decoders, dem, dem_decoder, erasure, exact_matcher,
               executor, fast_sampler, lattice_surgery, ldpc, ldpc_layout,
               memory, native, nn_decoder, osd_cuda, pauli_frame, scheduler,
               surface_code, topology, window_matcher)
from .dem_decoder import DemBPDecoder, decoder_from_numpy  # noqa: F401
from .fast_sampler import build_fast_sampler, sample_circuit_fast  # noqa: F401
from .ldpc import (bb_memory_circuit, gross_code,  # noqa: F401
                   run_bb_circuit_memory, small_bb_code)
from .erasure import run_erasure_memory  # noqa: F401
from .executor import execute  # noqa: F401
from .lattice_surgery import run_zz_surgery, zz_merge_split_circuit  # noqa: F401
from .memory import run_memory, MemoryResult  # noqa: F401
from .surface_code import memory_z_circuit, build_layout, code_metrics  # noqa: F401
from .exact_matcher import (exact_matcher_for_circuit,  # noqa: F401
                            tiered_matcher_for_circuit)
from .window_matcher import (window_matcher_for_circuit,  # noqa: F401
                             escalating_matcher_for_circuit)
from .cluster_matcher import cluster_matcher_for_circuit  # noqa: F401
