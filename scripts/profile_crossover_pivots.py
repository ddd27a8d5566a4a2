#!/usr/bin/env python
"""Profile the plain-crossover simplex pivot loop on one optLP family:
run the barrier (crossover off), then cProfile a bounded number of
crossover pivots to attribute the per-pivot cost.

Usage: JAX_PLATFORMS=cpu python scripts/profile_crossover_pivots.py mcom 1.0 400
"""
from __future__ import annotations

import cProfile
import pstats
import sys
import time

import numpy as np

from scripts.profile_perturb import make
from smart_crossover_tpu.solvers.settings import SolverSettings
from smart_crossover_tpu.solvers.simplex import primal_simplex
from smart_crossover_tpu.solvers.solving import (
    _crossover_statuses,
    solve_lp,
)


def main():
    fam = sys.argv[1] if len(sys.argv) > 1 else "mcom"
    scale = float(sys.argv[2]) if len(sys.argv) > 2 else 1.0
    budget = int(sys.argv[3]) if len(sys.argv) > 3 else 400
    lp = make(fam, scale)
    print(f"{lp.name}: m={lp.m} n={lp.n} nnz={lp.A.nnz}", flush=True)

    t0 = time.perf_counter()
    out = solve_lp(lp, method="barrier",
                   settings=SolverSettings(barrierTol=1e-10, presolve="on",
                                           crossover="off"))
    print(f"barrier: {out.status} {out.bar_iter_count} iters "
          f"{time.perf_counter()-t0:.1f}s", flush=True)

    A_std = lp.get_standard_A()
    c_std = lp.get_standard_c()
    l_std, u_std = lp.get_standard_bounds()
    x_std = lp.get_standard_x(out.x)
    vst = _crossover_statuses(x_std, l_std, u_std)
    print(f"proposed basic: {(vst == 0).sum()} of {vst.size} "
          f"(m={lp.m})", flush=True)

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    sres = primal_simplex(A_std, lp.b, c_std, l_std, u_std, vstatus=vst,
                          max_iter=budget, tol=1e-6, pricing="dantzig")
    prof.disable()
    dt = time.perf_counter() - t0
    print(f"{sres.iter_count} pivots in {dt:.1f}s = "
          f"{1e3*dt/max(sres.iter_count,1):.1f} ms/pivot ({sres.status})",
          flush=True)
    stats = pstats.Stats(prof)
    stats.sort_stats("cumulative").print_stats(18)


if __name__ == "__main__":
    main()
