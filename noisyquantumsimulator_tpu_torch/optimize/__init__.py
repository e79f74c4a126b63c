from .apparatus import ApparatusConstraints, OptimizationResult, SimulationCache  # noqa: F401
from .cost import compute_cost, compute_cost_arrays, extract_metrics  # noqa: F401
from .de import differential_evolution  # noqa: F401
from .engine import (build_fixed_problem, make_objective,  # noqa: F401
                     make_population_objective, make_value_and_grad,
                     problem_from_numpy)
from .forward import optimize_cz_gate, run_baseline  # noqa: F401
from .inverse import (explore_parameter_space, optimize_cz_parameters,  # noqa: F401
                      ExplorationResult)
from .sweeps import hardware_sweep, protocol_sweep, standard_research_sweeps  # noqa: F401
