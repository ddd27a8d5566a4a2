#!/usr/bin/env python
"""Phase-level profiling of the perturbation crossover on one optLP-scale
instance: wall-clocks each stage of run_perturb_algorithm separately so a
regression (ptb slower than ori) can be attributed to a stage.

Usage: JAX_PLATFORMS=cpu python scripts/profile_perturb.py stair|cover|mcom [scale]
"""
from __future__ import annotations

import sys
import time

import numpy as np

from smart_crossover_tpu.lp_methods.algorithms import (
    check_feasibility_problem,
    check_perturb_output_precision,
    get_perturb_problem,
)
from smart_crossover_tpu.solvers.settings import SolverSettings
from smart_crossover_tpu.solvers.solving import solve_lp

FAMS = {}


def make(fam: str, scale: float):
    from smart_crossover_tpu.data import lp_gen

    if fam == "stair":
        return lp_gen.staircase_lp(periods=max(int(60 * scale), 2),
                                   rows_per_period=max(int(500 * scale), 8),
                                   vars_per_period=max(int(1700 * scale), 16),
                                   seed=42)
    if fam == "cover":
        return lp_gen.windowed_cover_lp(m=max(int(30000 * scale), 40),
                                        n=max(int(100000 * scale), 120),
                                        seed=42)
    if fam == "mcom":
        return lp_gen.multicommodity_lp(grid=max(int(42 * scale), 4),
                                        commodities=max(int(14 * scale), 2),
                                        seed=42)
    if fam == "rail":
        return lp_gen.scattered_cover_lp(m=max(int(20000 * scale), 40),
                                         n=max(int(70000 * scale), 120),
                                         seed=42)
    if fam == "tran":
        return lp_gen.transport_windowed_lp(
            supplies=max(int(15000 * scale), 24),
            demands=max(int(15000 * scale), 24), seed=42)
    raise SystemExit(f"unknown family {fam}")


def main():
    fam = sys.argv[1] if len(sys.argv) > 1 else "stair"
    scale = float(sys.argv[2]) if len(sys.argv) > 2 else 1.0
    barrier_tol = 1e-10
    lp = make(fam, scale)
    print(f"{lp.name}: m={lp.m} n={lp.n} nnz={lp.A.nnz}", flush=True)

    marks = [("t0", time.perf_counter())]

    def mark(label):
        marks.append((label, time.perf_counter()))
        print(f"  [{marks[-1][1] - marks[-2][1]:8.2f}s] {label}", flush=True)

    barrier_output = solve_lp(
        lp, method="barrier",
        settings=SolverSettings(barrierTol=barrier_tol, presolve="on",
                                crossover="off"))
    mark(f"barrier1 ({barrier_output.status}, "
         f"{barrier_output.bar_iter_count} iters)")

    is_feas = check_feasibility_problem(lp)
    mark(f"check_feasibility_problem (is_feas={is_feas})")

    manager = get_perturb_problem(lp, barrier_output.x, barrier_output.y,
                                  1e-3, 1e-3, is_feas=is_feas)
    nfix = manager.get_num_fixed_variables()
    mark(f"get_perturb_problem (fixed {nfix}/{lp.n} vars, "
         f"{manager.get_num_fixed_constraints()} cons)")

    perturb_output = solve_lp(
        manager.lp_sub, method="barrier",
        settings=SolverSettings(presolve="on", crossover="on",
                                barrierMaxIters=60, certify="off",
                                timeLimit=900.0),
        warm_start_solution=(manager.get_subx(barrier_output.x),
                             barrier_output.y))
    mark(f"perturbed solve ({perturb_output.status}, "
         f"bar={perturb_output.bar_iter_count}, "
         f"pivots={perturb_output.iter_count})")

    if perturb_output.status == "OPTIMAL":
        ok = check_perturb_output_precision(manager, perturb_output.x, lp.c,
                                            barrier_output.obj_val)
        mark(f"gap check (pass={ok})")
        if not ok:
            final = solve_lp(
                lp, method="primal_simplex",
                settings=SolverSettings(presolve="on"),
                warm_start_solution=(
                    manager.recover_x_from_sub_x(perturb_output.x),
                    perturb_output.y),
                warm_start_basis=manager.recover_basis_from_sub_basis(
                    perturb_output.basis))
            mark(f"final simplex ({final.status}, pivots={final.iter_count})")

    total = marks[-1][1] - marks[0][1]
    print(f"TOTAL {total:.2f}s")


if __name__ == "__main__":
    main()
