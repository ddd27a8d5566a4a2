"""Fleet barrier solve (device batched IPM + host f64 refinement)."""
import numpy as np
import pytest
from scipy.optimize import linprog

from smart_crossover_tpu.solvers.ipm_fleet import ipm_fleet


def make_fleet(rng, B, m, n):
    As = rng.standard_normal((B, m, n))
    xs = rng.uniform(0.2, 0.8, (B, n))
    bs = np.einsum("bmn,bn->bm", As, xs)
    cs = rng.standard_normal((B, n))
    return As, bs, cs, np.zeros((B, n)), np.ones((B, n))


def test_ipm_fleet_matches_highs(rng):
    B, m, n = 6, 8, 20
    As, bs, cs, ls, us = make_fleet(rng, B, m, n)
    res = ipm_fleet(As, bs, cs, ls, us, tol=1e-8)
    assert all(s == "OPTIMAL" for s in res.status)
    for i in range(B):
        ref = linprog(cs[i], A_eq=As[i], b_eq=bs[i], bounds=[(0, 1)] * n,
                      method="highs")
        assert res.obj[i] == pytest.approx(ref.fun, abs=1e-7)
        # refined iterates satisfy the f64 KKT contract
        assert np.abs(As[i] @ res.x[i] - bs[i]).max() < 1e-8
        assert res.x[i].min() > -1e-10 and res.x[i].max() < 1 + 1e-10


def test_ipm_fleet_refinement_cheap(rng):
    """The host endgame must be a FEW iterations, not a re-solve: that is
    the whole point of doing the bulk on device."""
    B, m, n = 4, 10, 24
    As, bs, cs, ls, us = make_fleet(rng, B, m, n)
    res = ipm_fleet(As, bs, cs, ls, us, tol=1e-8, device_tol=1e-6)
    assert all(s == "OPTIMAL" for s in res.status)
    from smart_crossover_tpu.solvers.ipm import ipm_solve
    cold = ipm_solve(As[0], bs[0], cs[0], ls[0], us[0], tol=1e-8)
    # warm endgame at most half the cold iteration count on average
    assert res.refine_iters.mean() <= 0.5 * cold.iter_count + 1


def test_ipm_fleet_device_only(rng):
    B, m, n = 3, 6, 16
    As, bs, cs, ls, us = make_fleet(rng, B, m, n)
    res = ipm_fleet(As, bs, cs, ls, us, refine=False, device_tol=1e-9,
                    max_device_iters=60)
    assert all(s == "DEVICE_ONLY" for s in res.status)
    assert res.device_converged.all()
    for i in range(B):
        ref = linprog(cs[i], A_eq=As[i], b_eq=bs[i], bounds=[(0, 1)] * n,
                      method="highs")
        assert res.obj[i] == pytest.approx(ref.fun, abs=1e-6)


def test_ipm_big_single_large_lp(rng):
    """Single-big-LP path: device stage + B=1 endgame must reach 1e-8 and
    match HiGHS."""
    from smart_crossover_tpu.solvers.ipm_fleet import ipm_big

    m, n = 60, 150
    A = rng.standard_normal((m, n))
    x0 = rng.uniform(0.2, 0.8, n)
    b = A @ x0
    c = rng.standard_normal(n)
    res = ipm_big(A, b, c, np.zeros(n), np.ones(n), tol=1e-8)
    assert res.status == "OPTIMAL"
    ref = linprog(c, A_eq=A, b_eq=b, bounds=[(0, 1)] * n, method="highs")
    assert res.obj_val == pytest.approx(ref.fun, abs=1e-7)
    assert np.abs(A @ res.x - b).max() < 1e-8


def test_ipm_big_device_endgame(rng, monkeypatch):
    """Forced device-f32 NE endgame (solvers/ne_device.py): the
    iteratively-refined mixed-precision solves must reach the same f64
    KKT contract as the exact host path, and the device factor must
    actually carry the solves (no exact fallback on a benign LP)."""
    monkeypatch.setenv("SCX_DEVICE_ENDGAME", "1")
    import smart_crossover_tpu.solvers.ipm_fleet as fleet_mod
    from smart_crossover_tpu.solvers.ipm_fleet import ipm_big

    def no_exact(*a, **k):
        raise AssertionError("exact host NE path reached — device IR "
                             "solves did not carry the endgame")

    monkeypatch.setattr(fleet_mod, "_bmm", no_exact)

    m, n = 80, 220
    A = rng.standard_normal((m, n))
    x0 = rng.uniform(0.2, 0.8, n)
    b = A @ x0
    c = rng.standard_normal(n)
    res = ipm_big(A, b, c, np.zeros(n), np.ones(n), tol=1e-8)
    assert res.status == "OPTIMAL"
    ref = linprog(c, A_eq=A, b_eq=b, bounds=[(0, 1)] * n, method="highs")
    assert res.obj_val == pytest.approx(ref.fun, abs=1e-7)
    assert np.abs(A @ res.x - b).max() < 1e-8


def test_device_ne_solver_refines_to_f64(rng):
    """DeviceNE in isolation: f32 factor + IR reaches 1e-11 relative
    residual on an ill-scaled SPD system (d spanning 12 orders)."""
    from smart_crossover_tpu.solvers.ne_device import DeviceNE

    m, n = 40, 120
    A = rng.standard_normal((m, n))
    d = 10.0 ** rng.uniform(-6, 6, n)
    ne = DeviceNE(A, use_f64=False)   # pin the f32+CG path under test
    assert not ne.f64
    diag = ne.factor(d)
    assert diag == pytest.approx(np.einsum("mn,n,mn->m", A, d, A),
                                 rel=1e-5)
    reg = 1e-14 * (1.0 + diag.mean() + diag.max())
    M = (A * d) @ A.T + reg * np.eye(m)
    rhs = rng.standard_normal(m)
    dy, ok = ne.solve(rhs, lambda v: M @ v)
    assert ok
    assert np.linalg.norm(rhs - M @ dy) <= 1e-10 * np.linalg.norm(rhs)


def test_device_ne_direct_f64_path(rng):
    """Native-f64 backends (CPU here, the GPU) factor+solve the
    exact f64 system directly: eps-level residual in ONE solve, no CG,
    and the escalated-shift breakdown path is verified by the IR check."""
    from smart_crossover_tpu.solvers.ne_device import DeviceNE

    m, n = 40, 120
    A = rng.standard_normal((m, n))
    d = 10.0 ** rng.uniform(-6, 6, n)
    ne = DeviceNE(A)
    assert ne.f64   # conftest runs on CPU with x64 — probe must pass
    diag = ne.factor(d)
    assert diag == pytest.approx(np.einsum("mn,n,mn->m", A, d, A),
                                 rel=1e-12)
    reg = 1e-14 * (1.0 + diag.mean() + diag.max())
    M = (A * d) @ A.T + reg * np.eye(m)
    rhs = rng.standard_normal(m)
    dy, ok = ne.solve(rhs, lambda v: M @ v, rel_tol=1e-10, reg=reg)
    assert ok
    assert ne.stats["f64_direct"] == 1
    assert ne.stats["cg_iters"] == 0
    assert np.linalg.norm(rhs - M @ dy) <= 1e-10 * np.linalg.norm(rhs)

    # rank-deficient M (duplicate rows): reg=0 factor may break down;
    # the escalation + IR check must still deliver the exact solve of
    # the CALLER's (regularized, hence nonsingular) operator
    A2 = np.vstack([A, A[:1]])
    ne2 = DeviceNE(A2)
    diag2 = ne2.factor(d)
    reg2 = 1e-14 * (1.0 + diag2.mean() + diag2.max())
    M2 = (A2 * d) @ A2.T + reg2 * np.eye(m + 1)
    rhs2 = rng.standard_normal(m + 1)
    dy2, ok2 = ne2.solve(rhs2, lambda v: M2 @ v, rel_tol=1e-8, reg=reg2)
    if ok2:   # singular-at-zero-shift factors may legitimately refuse
        assert (np.linalg.norm(rhs2 - M2 @ dy2)
                <= 1e-8 * np.linalg.norm(rhs2))
