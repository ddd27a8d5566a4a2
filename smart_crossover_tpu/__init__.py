"""smart_crossover_tpu — an LP crossover framework in JAX.

A from-scratch JAX/XLA/Pallas reimplementation of the capabilities of the
smart-crossover reference codebase (network crossover for min-cost flow /
optimal transport, and perturbation crossover for general LP), with all the
solver machinery the reference delegated to Gurobi/CPLEX/Mosek implemented
in-house: Sinkhorn and PDHG first-order engines, an interior-point barrier,
a bounded-variable primal simplex, a warm-startable network simplex, and a
CG-based null-space projector.
"""
from smart_crossover_tpu.models import (
    Basis,
    GeneralLP,
    MinCostFlow,
    OptTransport,
    Output,
    StandardLP,
)
from smart_crossover_tpu.solvers.settings import SolverSettings
from smart_crossover_tpu.utils.timer import Timer

__version__ = "0.1.0"

__all__ = [
    "GeneralLP",
    "StandardLP",
    "MinCostFlow",
    "OptTransport",
    "Basis",
    "Output",
    "SolverSettings",
    "Timer",
    "__version__",
]


def __getattr__(name):
    # Lazy imports for the algorithm entry points to keep import costs low
    # and avoid circular imports during partial builds.
    if name in ("network_crossover", "column_generation"):
        from smart_crossover_tpu.network_methods import algorithms as _na

        return getattr(_na, name)
    if name == "run_perturb_algorithm":
        from smart_crossover_tpu.lp_methods.algorithms import run_perturb_algorithm

        return run_perturb_algorithm
    if name in ("solve_lp", "solve_mcf", "solve_ot"):
        from smart_crossover_tpu.solvers import solving as _sv

        return getattr(_sv, name)
    if name in ("batched_tnet_exact", "batched_lp_crossover"):
        from smart_crossover_tpu import parallel as _pl

        return getattr(_pl, name)
    if name == "ipm_fleet":
        from smart_crossover_tpu.solvers.ipm_fleet import ipm_fleet

        return ipm_fleet
    raise AttributeError(f"module 'smart_crossover_tpu' has no attribute {name!r}")
