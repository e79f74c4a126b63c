"""QEC layer of the port: the BB-LDPC circuit-level memory path.

  circuits      stabilizer-circuit IR (host numpy)
  dem           detector error model by frame propagation (host numpy)
  fast_sampler  one-matmul detector sampler (torch, explicit generator)
  ldpc          BB codes, min-sum BP (dense, edge-list, slot layout), OSD-0
  bp_cuda       kernel K3: the slot-layout check-node update, and its twin
  dem_decoder   tiered BP on the DEM + host OSD-0
  native        the C++ OSD-0 library (built with the host compiler)

The reference's other decoders, samplers and surface-code layers are not
ported yet; this package exports only what the port has.
"""
from . import (bp_cuda, circuits, dem, dem_decoder, fast_sampler,  # noqa: F401
               ldpc, native)
from .dem_decoder import DemBPDecoder, decoder_from_numpy  # noqa: F401
from .fast_sampler import build_fast_sampler, sample_circuit_fast  # noqa: F401
from .ldpc import (bb_memory_circuit, gross_code,  # noqa: F401
                   run_bb_circuit_memory, small_bb_code)
