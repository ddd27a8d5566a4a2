import numpy as np
import pytest
from scipy.optimize import linprog

from smart_crossover_tpu.models import GeneralLP
from smart_crossover_tpu.solvers.pdhg import pdhg_general_lp, pdhg_solve


def test_pdhg_simple_box():
    A = np.array([[1.0, 1.0]])
    res = pdhg_solve(A, [1.5], [-1.0, -2.0], np.zeros(2), np.ones(2),
                     tol=1e-7, max_iters=50_000)
    assert res.status == "OPTIMAL"
    assert res.obj_val == pytest.approx(-2.5, abs=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_pdhg_random_eq_lps(seed):
    rng = np.random.default_rng(seed)
    m, n = 8, 20
    A = rng.standard_normal((m, n))
    b = A @ rng.uniform(0.2, 0.8, n)
    c = rng.standard_normal(n)
    res = pdhg_solve(A, b, c, np.zeros(n), np.ones(n),
                     tol=1e-7, max_iters=200_000)
    ref = linprog(c, A_eq=A, b_eq=b, bounds=[(0, 1)] * n, method="highs")
    assert ref.status == 0
    assert res.status == "OPTIMAL"
    assert res.obj_val == pytest.approx(ref.fun, abs=1e-4)
    assert res.primal_residual < 1e-6


def test_pdhg_inequalities(rng):
    m, n = 6, 14
    A = rng.standard_normal((m, n))
    x0 = rng.uniform(0.2, 0.8, n)
    slack = np.where(rng.uniform(size=m) < 0.5, 0.3, 0.0)
    b = A @ x0 + slack
    sense = np.where(slack > 0, "<", "=")
    c = rng.standard_normal(n)
    lp = GeneralLP(A=A, b=b, c=c, l=np.zeros(n), u=np.ones(n), sense=sense)
    res = pdhg_general_lp(lp, tol=1e-7, max_iters=200_000)
    eq = sense == "="
    ref = linprog(c, A_eq=A[eq], b_eq=b[eq], A_ub=A[~eq], b_ub=b[~eq],
                  bounds=[(0, 1)] * n, method="highs")
    assert ref.status == 0
    assert res.status == "OPTIMAL"
    assert res.obj_val == pytest.approx(ref.fun, abs=1e-4)
    # dual sign convention: y <= 0 on '<' rows
    assert np.all(res.y[~eq] <= 1e-9)


def test_pdhg_warm_start_converges_faster(rng):
    m, n = 8, 20
    A = rng.standard_normal((m, n))
    b = A @ rng.uniform(0.2, 0.8, n)
    c = rng.standard_normal(n)
    cold = pdhg_solve(A, b, c, np.zeros(n), np.ones(n), tol=1e-7,
                      max_iters=200_000)
    warm = pdhg_solve(A, b, c, np.zeros(n), np.ones(n), tol=1e-7,
                      max_iters=200_000, x0=cold.x, y0=cold.y)
    assert warm.status == "OPTIMAL"
    assert warm.iter_count <= cold.iter_count


def test_pdhg_sparse_bcoo_path(rng):
    import scipy.sparse as sp

    m, n = 10, 30
    A_sp = sp.random(m, n, density=0.3, random_state=3, format="csr")
    A_sp = A_sp + sp.eye(m, n)
    x0 = rng.uniform(0.2, 0.8, n)
    b = np.asarray(A_sp @ x0).ravel()
    c = rng.standard_normal(n)
    lp = GeneralLP(A=A_sp, b=b, c=c, l=np.zeros(n), u=np.ones(n),
                   sense=np.full(m, "="))
    dense = pdhg_general_lp(lp, tol=1e-7, max_iters=200_000, sparse=False)
    bcoo = pdhg_general_lp(lp, tol=1e-7, max_iters=200_000, sparse=True)
    assert dense.status == bcoo.status == "OPTIMAL"
    assert bcoo.obj_val == pytest.approx(dense.obj_val, abs=1e-4)


def test_solve_lp_first_order_method(rng):
    from smart_crossover_tpu.solvers.settings import SolverSettings
    from smart_crossover_tpu.solvers.solving import solve_lp

    m, n = 8, 20
    A = rng.standard_normal((m, n))
    b = A @ rng.uniform(0.2, 0.8, n)
    lp = GeneralLP(A=A, b=b, c=rng.standard_normal(n), l=np.zeros(n),
                   u=np.ones(n), sense=np.full(m, "="))
    out = solve_lp(lp, method="first_order",
                   settings=SolverSettings(barrierTol=1e-6,
                                           firstOrderMaxIters=200_000))
    ref = linprog(lp.c, A_eq=A, b_eq=b, bounds=[(0, 1)] * n, method="highs")
    assert out.status == "OPTIMAL"
    assert out.obj_val == pytest.approx(ref.fun, abs=1e-3)
    assert out.x_bar is not None


def test_pdhg_checkpoint_resume(rng, tmp_path):
    from smart_crossover_tpu.utils.checkpoint import load_state, save_state

    m, n = 8, 20
    A = rng.standard_normal((m, n))
    b = A @ rng.uniform(0.2, 0.8, n)
    c = rng.standard_normal(n)
    # phase 1: a short budget, checkpoint the iterate
    part = pdhg_solve(A, b, c, np.zeros(n), np.ones(n), tol=1e-12,
                      max_iters=2000)
    save_state(tmp_path / "pdhg.npz", x=part.x, y=part.y)
    # phase 2: resume from the checkpoint and finish
    st = load_state(tmp_path / "pdhg.npz")
    done = pdhg_solve(A, b, c, np.zeros(n), np.ones(n), tol=1e-7,
                      max_iters=200_000, x0=st["x"], y0=st["y"])
    ref = linprog(c, A_eq=A, b_eq=b, bounds=[(0, 1)] * n, method="highs")
    assert done.status == "OPTIMAL"
    assert done.obj_val == pytest.approx(ref.fun, abs=1e-4)


def test_pdhg_tight_kkt_dense():
    # VERDICT.md item 5 regression: adaptive (PDLP) restarts + step size +
    # active-set polish must reach 1e-8 KKT on a dense instance where the
    # round-1 fixed-period variant stalled at ~7e-7 even after 500k iters
    rng = np.random.default_rng(7)
    m, n = 200, 800
    A = rng.normal(size=(m, n)) / np.sqrt(m)
    b = A @ rng.uniform(0.0, 1.0, n)
    c = rng.normal(size=n)
    res = pdhg_solve(A, b, c, np.zeros(n), np.full(n, 2.0),
                     tol=1e-8, max_iters=30_000)
    assert res.status == "OPTIMAL"
    assert max(res.primal_residual, res.dual_residual, res.gap) < 1e-8
    ref = linprog(c, A_eq=A, b_eq=b, bounds=[(0, 2.0)] * n, method="highs")
    assert res.obj_val == pytest.approx(ref.fun, rel=1e-7)


def test_pdhg_tight_kkt_sparse_lp():
    # the 1500x6000 'optLP-like' class scaled down for CI: 1e-8 KKT within
    # the iteration budget, real (non-NaN) gap and dual residual reported
    from smart_crossover_tpu.data.lp_gen import random_sparse_lp

    lp = random_sparse_lp(m=300, n=1200, seed=3)
    res = pdhg_general_lp(lp, tol=1e-8, max_iters=60_000)
    assert res.status == "OPTIMAL"
    assert np.isfinite(res.gap) and np.isfinite(res.dual_residual)
    assert max(res.primal_residual, res.dual_residual, res.gap) < 1e-8


def test_pdhg_first_update_keeps_eta_alive(rng):
    """Regression (ADVICE r2): the PDLP step-size schedule must use index
    k+2 on the first update — with k+1 the reduction factor is
    (1 - 1**-0.3) = 0, collapsing eta to the clip floor and wasting a
    ~250-iteration recovery prefix.  On this instance the fixed schedule
    measures 680 iterations to 1e-6 and the buggy one 1960 — assert the
    midpoint as the regression bound."""
    m, n = 6, 14
    A = rng.standard_normal((m, n))
    x0 = rng.uniform(0.2, 0.8, n)
    b = A @ x0
    c = rng.standard_normal(n)
    res = pdhg_solve(A, b, c, np.zeros(n), np.ones(n), tol=1e-6,
                     max_iters=2000, restart_period=40, polish=False)
    assert res.status == "OPTIMAL"
    assert res.iter_count <= 1000


def test_pdhg_halpern_mode_matches_adaptive(rng):
    """Restarted reflected-Halpern PDHG (mode='halpern') reaches the same
    optimum as the adaptive-step oracle and HiGHS."""
    from scipy.optimize import linprog

    m, n = 40, 160
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    b = A @ rng.uniform(0.2, 0.8, n)
    c = A.T @ rng.standard_normal(m) + np.abs(rng.standard_normal(n)) + 0.05
    l = np.zeros(n)
    u = np.full(n, 2.0)
    ref = linprog(c, A_eq=A, b_eq=b, bounds=[(0, 2)] * n, method="highs")
    r = pdhg_solve(A, b, c, l, u, tol=1e-7, max_iters=60_000,
                   mode="halpern")
    assert r.status == "OPTIMAL"
    assert abs(r.obj_val - ref.fun) < 1e-5 * (1 + abs(ref.fun))


@pytest.mark.parametrize("mode", ["adaptive", "halpern"])
def test_pdhg_unaligned_mixed_rows_match_highs(rng, mode):
    """A deliberately unaligned 12 x 50 LP with '=' and '<' rows, in both
    restart modes, against HiGHS."""
    m, n = 12, 50
    A = rng.standard_normal((m, n))
    b = A @ rng.uniform(0.1, 0.9, n)
    sense = np.array(["="] * 6 + ["<"] * 6)
    b = b + np.where(sense == "<", 0.3, 0.0)
    c = rng.standard_normal(n)
    res = pdhg_solve(A, b, c, np.zeros(n), np.ones(n), sense=sense,
                     tol=1e-8, max_iters=20000, mode=mode)
    ref = linprog(c, A_eq=A[:6], b_eq=b[:6], A_ub=A[6:], b_ub=b[6:],
                  bounds=[(0, 1)] * n, method="highs")
    assert res.status == "OPTIMAL"
    assert res.obj_val == pytest.approx(ref.fun, abs=1e-6)


def test_full_precision_matmuls_scopes_the_trace():
    """full_precision_matmuls traces its function under 'highest' and
    leaves the caller's default alone."""
    import jax

    from smart_crossover_tpu.config import full_precision_matmuls

    seen = []
    wrapped = full_precision_matmuls(
        lambda: seen.append(jax.config.jax_default_matmul_precision))
    before = jax.config.jax_default_matmul_precision
    wrapped()
    assert seen == ["highest"]
    assert jax.config.jax_default_matmul_precision == before
