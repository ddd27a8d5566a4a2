"""Stage breakdown of the flagship large-LP perturbation crossover.

Builds a 3000x12000-class sparse LP (general rows, a slice of free
variables) and profiles `run_perturb_algorithm` end-to-end with per-stage
timers, to locate what the device can take over.

Usage: python scripts/profile_perturb_large.py [m n] (default 3000 12000)
"""
from __future__ import annotations

import sys
import time

import numpy as np
import scipy.sparse as sp


def make_sparse_lp(m=3000, n=12000, seed=7, density=8.0, n_free=None):
    """Sparse general LP: ~density nnz per column, bounded + free vars."""
    rng = np.random.default_rng(seed)
    nnz = int(density * n)
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz)
    A = sp.csr_matrix((vals, (rows, cols)), shape=(m, n))
    A = A + sp.eye(m, n, format="csr")          # full row rank-ish anchor
    x_feas = rng.uniform(0.2, 0.8, n)
    b = A @ x_feas
    l = np.zeros(n)
    u = np.full(n, np.inf)
    u[rng.choice(n, n // 4, replace=False)] = rng.uniform(1.0, 3.0, n // 4)
    if n_free is None:
        n_free = int(0.05 * n)                  # ~584 at n=12000 scale
    free_idx = rng.choice(n, n_free, replace=False)
    l[free_idx] = -np.inf
    u[free_idx] = np.inf
    # bounded by construction: c = A'y0 + margin, margin >= 0 and zero on
    # free columns (a random c on a free column is an unbounded ray)
    y0 = rng.standard_normal(m)
    margin = np.abs(rng.standard_normal(n)) + 0.01
    margin[free_idx] = 0.0
    c = np.asarray(A.T @ y0).ravel() + margin
    return A, b, c, l, u


def main():
    from smart_crossover_tpu.models.formats import GeneralLP
    from smart_crossover_tpu.lp_methods.algorithms import (
        run_perturb_algorithm,
    )

    args = [int(a) for a in sys.argv[1:]]
    m, n = args if len(args) == 2 else (3000, 12000)
    A, b, c, l, u = make_sparse_lp(m, n)
    lp = GeneralLP(A=A, b=b, c=c, l=l, u=u,
                   sense=np.array(["="] * m))

    t0 = time.perf_counter()
    out = run_perturb_algorithm(lp)
    dt = time.perf_counter() - t0
    print(f"\nend-to-end: {dt:.1f}s status={out.status} "
          f"obj={out.obj_val:.6e} iters={out.iter_count}")
    if out.runtime is not None:
        print("reported runtime:", out.runtime)


if __name__ == "__main__":
    main()
