"""Multi-device layer on torch.distributed: meshes over a process group,
the sharded BB-LDPC Monte Carlo and the sharded DE population objective.
`shard_leading` and `replicated` (jax shardings) have no counterpart: a
rank takes its rows with `local_rows`, and what is not split is held whole
by every rank."""
from .mesh import (init_rank, launch, local_rows, make_mesh,  # noqa: F401
                   mesh_shape, pad_to_multiple)
from . import bb_mc, de_sharded  # noqa: F401
from .bb_mc import run_bb_memory_sharded  # noqa: F401
from .de_sharded import make_population_objective_sharded  # noqa: F401
