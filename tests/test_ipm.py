import numpy as np
import pytest
from scipy.optimize import linprog

from smart_crossover_tpu.models import GeneralLP
from smart_crossover_tpu.solvers.ipm import ipm_general_lp, ipm_solve


def highs_opt(A, b, c, l, u):
    bounds = [(lo if np.isfinite(lo) else None, up if np.isfinite(up) else None)
              for lo, up in zip(l, u)]
    ref = linprog(c, A_eq=A, b_eq=b, bounds=bounds, method="highs")
    assert ref.status == 0
    return ref


def test_ipm_simple_box():
    A = np.array([[1.0, 1.0]])
    b = [1.5]
    c = [-1.0, -2.0]
    l, u = np.zeros(2), np.ones(2)
    res = ipm_solve(A, b, c, l, u)
    assert res.status == "OPTIMAL"
    ref = highs_opt(A, b, c, l, u)
    assert res.obj_val == pytest.approx(ref.fun, abs=1e-7)
    # iterate strictly interior
    assert np.all(res.x > l) and np.all(res.x < u)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ipm_random_lps(seed):
    rng = np.random.default_rng(seed)
    m, n = 10, 25
    A = rng.standard_normal((m, n))
    b = A @ rng.uniform(0.2, 0.8, n)
    c = rng.standard_normal(n)
    l, u = np.zeros(n), np.ones(n)
    res = ipm_solve(A, b, c, l, u)
    ref = highs_opt(A, b, c, l, u)
    assert res.status == "OPTIMAL"
    assert res.obj_val == pytest.approx(ref.fun, abs=1e-6, rel=1e-8)
    np.testing.assert_allclose(A @ res.x, b, atol=1e-6)


def test_ipm_one_sided_and_free(seed=4):
    rng = np.random.default_rng(seed)
    m, n = 6, 14
    A = rng.standard_normal((m, n))
    b = A @ rng.uniform(-0.3, 0.7, n)
    l = np.full(n, 0.0)
    u = np.full(n, np.inf)
    l[0], u[0] = -np.inf, np.inf      # free var
    l[1] = -np.inf                    # upper-bounded only
    u[1] = 2.0
    # construct a dual-feasible cost so the LP is bounded:
    # c = A'y0 + zl - zu with zl, zu >= 0 matched to the bound pattern
    y0 = rng.standard_normal(m)
    zl0 = np.abs(rng.standard_normal(n)) + 0.1
    zl0[0] = 0.0                      # free var: no bound multipliers
    zu0 = np.zeros(n)
    zl0[1], zu0[1] = 0.0, np.abs(rng.standard_normal()) + 0.1
    c = A.T @ y0 + zl0 - zu0
    res = ipm_solve(A, b, c, l, u)
    ref = highs_opt(A, b, c, l, u)
    assert res.status == "OPTIMAL"
    assert res.obj_val == pytest.approx(ref.fun, abs=1e-5, rel=1e-7)


def test_ipm_general_lp_with_ineq(rng):
    # GeneralLP with '<' rows goes through slack augmentation
    m, n = 5, 10
    A = rng.standard_normal((m, n))
    x0 = rng.uniform(0.2, 0.8, n)
    b = A @ x0 + np.array([0.0, 0.1, 0.0, 0.2, 0.0])
    sense = np.array(["=", "<", "=", "<", "="])
    lp = GeneralLP(A=A, b=b, c=rng.standard_normal(n), l=np.zeros(n),
                   u=np.ones(n), sense=sense)
    res = ipm_general_lp(lp)
    assert res.status == "OPTIMAL"
    # oracle via explicit slack form
    A_std = lp.get_standard_A().toarray()
    c_std = lp.get_standard_c()
    l_std, u_std = lp.get_standard_bounds()
    ref = highs_opt(A_std, lp.b, c_std, l_std, u_std)
    assert res.obj_val == pytest.approx(ref.fun, abs=1e-6, rel=1e-8)
    assert res.x.size == n


def test_ipm_detects_unbounded():
    A = np.array([[1.0, -1.0]])
    res = ipm_solve(A, [0.0], [-1.0, 0.0], np.zeros(2), np.full(2, np.inf))
    assert res.status in ("UNBOUNDED", "NUMERICAL_ERROR",
                          "ITERATION_LIMIT", "STALLED")
    assert res.status != "OPTIMAL"


def test_ipm_dual_solution_quality(rng):
    m, n = 8, 18
    A = rng.standard_normal((m, n))
    b = A @ rng.uniform(0.2, 0.8, n)
    # bounded by construction: c dual-feasible
    c = A.T @ rng.standard_normal(m) + np.abs(rng.standard_normal(n)) + 0.05
    l, u = np.zeros(n), np.full(n, np.inf)
    res = ipm_solve(A, b, c, l, u)
    assert res.status == "OPTIMAL"
    # dual feasibility: c - A'y - zl + zu ~ 0, zl >= 0
    rd = c - A.T @ res.y - res.zl + res.zu
    assert np.linalg.norm(rd) < 1e-6
    assert np.all(res.zl >= 0)


def test_ipm_warm_start_reduces_iterations():
    """A warm start from a solved instance's solution should converge in
    fewer iterations than the cold solve, to the same objective; garbage
    warm starts are ignored rather than poisoning the solve."""
    import scipy.sparse as sp

    rng = np.random.default_rng(11)
    m, n = 40, 120
    A = sp.random(m, n, density=0.15, random_state=1, format="csr")
    A = (A + sp.hstack([sp.eye(m), sp.csr_matrix((m, n - m))])).tocsr()
    x0 = rng.random(n)
    b = A @ x0
    y0 = rng.normal(size=m)
    c = A.T @ y0 + rng.random(n) + 0.01
    l = np.zeros(n)
    u = np.full(n, np.inf)

    cold = ipm_solve(A, b, c, l, u)
    assert cold.status == "OPTIMAL"
    warm = ipm_solve(A, b, c, l, u, x0=cold.x, y0=cold.y)
    assert warm.status == "OPTIMAL"
    assert warm.obj_val == pytest.approx(cold.obj_val, rel=1e-8)
    assert warm.iter_count <= cold.iter_count

    nan_warm = ipm_solve(A, b, c, l, u,
                         x0=np.full(n, np.nan), y0=np.full(m, np.nan))
    assert nan_warm.status == "OPTIMAL"
    assert nan_warm.obj_val == pytest.approx(cold.obj_val, rel=1e-8)


def test_ipm_banded_conditioning():
    # VERDICT.md item 8 / STATUS.md round-1 #6 regression: banded constraint
    # matrices with 1e3-range coefficient spreads used to exit NEAR_OPTIMAL
    # with ~1e-3 objective error; f64 iterative refinement on the normal
    # equations must now deliver OPTIMAL at 1e-8
    from scipy.optimize import linprog

    rng = np.random.default_rng(0)
    m, n, bw = 200, 400, 12
    A = np.zeros((m, n))
    for i in range(m):
        j0 = int(i * (n - bw) / (m - 1))
        A[i, j0:j0 + bw] = (rng.standard_normal(bw)
                            * np.logspace(0, 3, bw)[rng.permutation(bw)])
    b = A @ rng.uniform(0.2, 0.8, n)
    c = rng.standard_normal(n)
    res = ipm_solve(A, b, c, np.zeros(n), np.ones(n), tol=1e-8)
    assert res.status == "OPTIMAL"
    ref = linprog(c, A_eq=A, b_eq=b, bounds=[(0, 1)] * n, method="highs")
    assert abs(res.obj_val - ref.fun) / (1 + abs(ref.fun)) < 1e-8


def test_ipm_staircase_conditioning():
    # staircase blocks with 1e5 coefficient spread (the harsher variant of
    # the same conditioning class)
    from scipy.optimize import linprog

    rng = np.random.default_rng(1)
    nblocks, bs, overlap, spread = 20, 20, 4, 1e5
    m = nblocks * bs
    n = nblocks * 2 * bs - (nblocks - 1) * overlap
    A = np.zeros((m, n))
    col = 0
    for k in range(nblocks):
        blk = rng.standard_normal((bs, 2 * bs)) \
            * spread ** rng.uniform(-1, 1, (bs, 2 * bs))
        A[k * bs:(k + 1) * bs, col:col + 2 * bs] = blk
        col += 2 * bs - overlap
    b = A @ rng.uniform(0.2, 0.8, n)
    c = rng.standard_normal(n)
    res = ipm_solve(A, b, c, np.zeros(n), np.ones(n), tol=1e-8)
    assert res.status == "OPTIMAL"
    ref = linprog(c, A_eq=A, b_eq=b, bounds=[(0, 1)] * n, method="highs")
    assert abs(res.obj_val - ref.fun) / (1 + abs(ref.fun)) < 1e-7


def test_ipm_degenerate_vertex_endgame_precision():
    """Degenerate optimal vertex (sparse support, oversubscribed
    zero-margin duals, free variables): the extended-precision endgame
    residuals must deliver pinf at f64 roundoff, not a 1e-8 floor
    (VERDICT r2 item 8 / STATUS.md #0)."""
    import scipy.sparse as sp

    from smart_crossover_tpu.solvers.ipm import ipm_solve

    rng = np.random.default_rng(7)
    m, n = 300, 1200
    nnz = 8 * n
    A = sp.csr_matrix((rng.standard_normal(nnz),
                       (rng.integers(0, m, nnz), rng.integers(0, n, nnz))),
                      shape=(m, n)) + sp.eye(m, n, format="csr")
    supp = rng.choice(n, m // 2, replace=False)
    x_star = np.zeros(n)
    x_star[supp] = rng.uniform(0.5, 2.0, m // 2)
    l = np.zeros(n)
    u = np.full(n, np.inf)
    free_idx = rng.choice(n, n // 20, replace=False)
    l[free_idx] = -np.inf
    b = A @ x_star
    margin = np.abs(rng.standard_normal(n)) + 0.01
    margin[rng.choice(n, m, replace=False)] = 0.0
    margin[supp] = 0.0
    margin[free_idx] = 0.0
    c = np.asarray(A.T @ rng.standard_normal(m)).ravel() + margin
    res = ipm_solve(A, b, c, l, u, tol=1e-8)
    assert res.status == "OPTIMAL"
    pinf = np.linalg.norm(b - A @ res.x) / (1 + np.linalg.norm(b))
    assert pinf < 1e-10, pinf


def test_factor_spd_accepts_dense_ndarray():
    """_factor_spd must handle dense products identically to sparse
    input."""
    import scipy.sparse as sp

    from smart_crossover_tpu.solvers.ipm import _factor_spd

    rng = np.random.default_rng(0)
    m = 40
    B = rng.standard_normal((m, 3 * m))
    M = B @ B.T
    rhs = rng.standard_normal((m, 5))
    s_dense = _factor_spd(M, 1e-12)(rhs)
    s_sparse = _factor_spd(sp.csr_matrix(M), 1e-12, force_dense=True)(rhs)
    np.testing.assert_allclose(s_dense, s_sparse, rtol=1e-9)
    x = np.linalg.solve(M + 1e-12 * np.eye(m), rhs)
    np.testing.assert_allclose(s_dense, x, rtol=1e-6, atol=1e-9)


def test_ipm_wide_free_variable_set():
    """>128 free columns take the wide_free branch (plain normal equations
    with the d-cap pinned at 1e10 throughout, ipm.py) rather than the
    bordered/augmented path; it must still reach OPTIMAL with tight
    residuals vs the HiGHS oracle (ADVICE r4 item 4)."""
    import scipy.sparse as sp
    from scipy.optimize import linprog

    from smart_crossover_tpu.solvers.ipm import ipm_solve

    rng = np.random.default_rng(11)
    m, n = 250, 1000
    nnz = 8 * n
    A = sp.csr_matrix((rng.standard_normal(nnz),
                       (rng.integers(0, m, nnz), rng.integers(0, n, nnz))),
                      shape=(m, n)) + sp.eye(m, n, format="csr")
    l = np.zeros(n)
    u = np.full(n, np.inf)
    free_idx = rng.choice(n, 200, replace=False)   # > the 128 gate
    l[free_idx] = -np.inf
    x0 = rng.uniform(0.2, 0.8, n)
    x0[free_idx] = rng.uniform(-1.0, 1.0, 200)
    b = np.asarray(A @ x0).ravel()
    # bounded dual-feasible cost: zero margin on free columns
    margin = np.abs(rng.standard_normal(n)) + 0.01
    margin[free_idx] = 0.0
    c = np.asarray(A.T @ rng.standard_normal(m)).ravel() + margin
    res = ipm_solve(A, b, c, l, u, tol=1e-8)
    assert res.status == "OPTIMAL"
    pinf = np.linalg.norm(b - A @ res.x) / (1 + np.linalg.norm(b))
    assert pinf < 1e-8, pinf
    bounds = [(None if li == -np.inf else li, None) for li in l]
    ref = linprog(c, A_eq=A.toarray(), b_eq=b, bounds=bounds, method="highs")
    assert ref.status == 0
    assert abs(res.obj_val - ref.fun) / (1 + abs(ref.fun)) < 1e-7
