"""Round-3 closing soak: randomized checks across every API family.

Covers the round-3 additions alongside the standing surface: certified
exact fleets (all three device simplex engines), the fleet barrier,
Halpern PDHG, the pure-dual endgame, crossovers vs HiGHS, the
perturbation path, and .lp round-trips.  Prints one JSON summary line.

Usage: JAX_PLATFORMS=cpu python scripts/soak_round3.py
"""
from __future__ import annotations

import json
import time

import numpy as np
from scipy.optimize import linprog

CHECKS = 0
FAILS: list[str] = []


def check(name, ok):
    global CHECKS
    CHECKS += 1
    if not ok:
        FAILS.append(name)
        print(f"FAIL: {name}", flush=True)


def ot_vs_highs(rng, S, D):
    import smart_crossover_tpu as scx
    from smart_crossover_tpu.solvers.sinkhorn import sinkhorn

    s = rng.uniform(0.5, 2, S)
    d = rng.uniform(0.5, 2, D)
    d *= s.sum() / d.sum()
    ot = scx.OptTransport(s=s, d=d, M=rng.uniform(0, 5, (S, D)))
    mcf = ot.to_MCF()
    ref = linprog(mcf.c, A_eq=mcf.A.toarray(), b_eq=mcf.b,
                  bounds=[(0, None)] * mcf.n, method="highs")
    x = sinkhorn(ot, reg=0.02, num_iters=400)
    for method in ("tnet", "cnet_ot"):
        out = scx.network_crossover(x=x, ot=ot, method=method)
        check(f"{method} {S}x{D}",
              out.status == "OPTIMAL"
              and abs(out.obj_val - ref.fun) < 1e-7 * (1 + abs(ref.fun)))
    return ot, ref.fun


def main():
    t0 = time.perf_counter()
    rng = np.random.default_rng(31)

    # 1) OT crossovers vs HiGHS -------------------------------------------
    for S, D in ((14, 18), (25, 20), (32, 32)):
        ot_vs_highs(rng, S, D)

    # 2) MCF crossover (cnet_mcf) vs HiGHS --------------------------------
    import smart_crossover_tpu as scx
    from smart_crossover_tpu.data.mcf_gen import transshipment_mcf
    from smart_crossover_tpu.solvers.settings import SolverSettings
    from smart_crossover_tpu.solvers.solving import solve_lp, solve_mcf, \
        solve_ot

    for seed in (1, 2):
        mcf = transshipment_mcf(m=120, arcs_per_node=5, seed=seed)
        ref = linprog(mcf.c, A_eq=mcf.A.toarray(), b_eq=mcf.b,
                      bounds=list(zip(np.zeros(mcf.n), mcf.u)),
                      method="highs")
        warm = solve_mcf(mcf, method="first_order",
                         settings=SolverSettings(crossover="off",
                                                 barrierTol=1e-5))
        out = scx.network_crossover(x=warm.x, mcf=mcf, method="cnet_mcf")
        check(f"cnet_mcf seed{seed}",
              out.status == "OPTIMAL"
              and abs(out.obj_val - ref.fun) < 1e-7 * (1 + abs(ref.fun)))

    # 3) certified exact fleets, all three device engines ------------------
    from smart_crossover_tpu.network_methods.certify import (
        certify_ot_basis_batch,
    )
    from smart_crossover_tpu.parallel.batched import (
        batched_tnet_exact_device,
    )

    B, S, D = 4, 20, 24
    s = rng.uniform(0.5, 2, (B, S))
    d = rng.uniform(0.5, 2, (B, D))
    d *= (s.sum(1) / d.sum(1))[:, None]
    M = rng.uniform(0, 5, (B, S, D))
    objs = {}
    for eng in ("mask", "parent", "anc"):
        X, obj, push, piv, opt, Bm = batched_tnet_exact_device(
            s, d, M, reg=0.01, sinkhorn_iters=400, engine=eng)
        certs = certify_ot_basis_batch(np.asarray(Bm), s, d, M)
        check(f"fleet engine {eng} optimal+certified",
              bool(np.all(np.asarray(opt))) and all(c.ok for c in certs))
        objs[eng] = np.array([c.obj_val for c in certs])
    check("fleet engines agree",
          np.allclose(objs["mask"], objs["parent"], rtol=1e-9)
          and np.allclose(objs["mask"], objs["anc"], rtol=1e-9))

    # 4) fleet barrier (device stage + f64 endgame) ------------------------
    from smart_crossover_tpu.solvers.ipm_fleet import ipm_fleet

    r4 = np.random.default_rng(314)
    Bf, mf, nf = 8, 12, 30
    Af = r4.standard_normal((Bf, mf, nf))
    bf = np.einsum("bmn,bn->bm", Af, r4.uniform(0.2, 0.8, (Bf, nf)))
    cf = r4.standard_normal((Bf, nf))
    fl = ipm_fleet(Af, bf, cf, np.zeros((Bf, nf)), np.ones((Bf, nf)),
                   tol=1e-8)
    for i in range(Bf):
        ref = linprog(cf[i], A_eq=Af[i], b_eq=bf[i],
                      bounds=[(0, 1)] * nf, method="highs")
        check(f"ipm_fleet inst{i}",
              fl.status[i] == "OPTIMAL"
              and abs(fl.obj[i] - ref.fun) < 1e-6 * (1 + abs(ref.fun)))

    # 5) PDHG adaptive vs halpern vs HiGHS ---------------------------------
    from smart_crossover_tpu.solvers.pdhg import pdhg_solve

    for seed in (5, 6, 7):
        r2 = np.random.default_rng(seed)
        m, n = 30, 120
        A = r2.standard_normal((m, n)) / np.sqrt(m)
        b = A @ r2.uniform(0.2, 0.8, n)
        c = A.T @ r2.standard_normal(m) + np.abs(r2.standard_normal(n)) \
            + 0.05
        ref = linprog(c, A_eq=A, b_eq=b, bounds=[(0, 2)] * n,
                      method="highs")
        for mode in ("adaptive", "halpern"):
            r = pdhg_solve(A, b, c, np.zeros(n), np.full(n, 2.0),
                           tol=1e-7, max_iters=60_000, mode=mode)
            check(f"pdhg {mode} seed{seed}",
                  r.status == "OPTIMAL"
                  and abs(r.obj_val - ref.fun) < 1e-5 * (1 + abs(ref.fun)))

    # 6) pure-dual endgame: zero primal fallbacks --------------------------
    from smart_crossover_tpu.solvers.simplex import dual_simplex

    n_fb = 0
    for seed in range(20):
        r2 = np.random.default_rng(seed + 100)
        m, n = 8, 20
        A = r2.standard_normal((m, n))
        l = np.where(r2.random(n) < 0.25, -np.inf, 0.0)
        u = np.where(r2.random(n) < 0.25, np.inf, r2.uniform(0.5, 2.0, n))
        b = A @ np.where(np.isfinite(u), u * 0.4, 0.7)
        c = r2.standard_normal(n)
        vst = r2.choice([-1, -2, -3, 0], size=n).astype(np.int8)
        res = dual_simplex(A, b, c, l, u, vstatus=vst, max_iter=20000)
        n_fb += res.fallback
        ref = linprog(c, A_eq=A, b_eq=b,
                      bounds=[(lo if np.isfinite(lo) else None,
                               hi if np.isfinite(hi) else None)
                              for lo, hi in zip(l, u)], method="highs")
        if ref.status == 0:
            check(f"dual seed{seed}",
                  res.status == "OPTIMAL"
                  and abs(res.obj_val - ref.fun) < 1e-5 * (1 + abs(ref.fun)))
    check("pure-dual zero fallbacks", n_fb == 0)

    # 7) perturbation crossover vs HiGHS -----------------------------------
    from smart_crossover_tpu.models.formats import GeneralLP

    for seed in (3, 4):
        r2 = np.random.default_rng(seed)
        m, n = 25, 60
        A = r2.standard_normal((m, n))
        b = A @ r2.uniform(0.2, 0.8, n)
        c = A.T @ r2.standard_normal(m) + np.abs(r2.standard_normal(n)) \
            + 0.05
        glp = GeneralLP(A=A, b=b, c=c, l=np.zeros(n), u=np.full(n, np.inf),
                        sense=np.array(["="] * m))
        out = solve_lp(glp, method="barrier_perturb")
        ref = linprog(c, A_eq=A, b_eq=b, bounds=[(0, None)] * n,
                      method="highs")
        check(f"perturb seed{seed}",
              out.status == "OPTIMAL"
              and abs(out.obj_val - ref.fun) < 1e-6 * (1 + abs(ref.fun)))

    # 8) solve_ot device_simplex with the anc engine ------------------------
    sot = rng.uniform(0.5, 2, 16)
    dot_ = rng.uniform(0.5, 2, 20)
    dot_ *= sot.sum() / dot_.sum()
    ot = scx.OptTransport(s=sot, d=dot_, M=rng.uniform(0, 5, (16, 20)))
    mcf = ot.to_MCF()
    ref = linprog(mcf.c, A_eq=mcf.A.toarray(), b_eq=mcf.b,
                  bounds=[(0, None)] * mcf.n, method="highs")
    o = solve_ot(ot, method="device_simplex",
                 settings=SolverSettings(deviceSimplexEngine="anc"))
    check("solve_ot device_simplex anc",
          o.status == "OPTIMAL" and abs(o.obj_val - ref.fun) < 1e-7)

    # 9) .lp round-trip ------------------------------------------------------
    import tempfile

    from smart_crossover_tpu.data.lp_format import read_lp, write_lp
    from smart_crossover_tpu.data.lp_gen import random_sparse_lp

    for seed in (8, 9):
        glp = random_sparse_lp(m=12, n=30, seed=seed)
        with tempfile.NamedTemporaryFile(suffix=".lp", delete=False) as f:
            path = f.name
        write_lp(glp, path)
        glp2 = read_lp(path)
        o1 = solve_lp(glp, method="simplex")
        o2 = solve_lp(glp2, method="simplex")
        check(f"lp roundtrip seed{seed}",
              o1.status == o2.status
              and (o1.obj_val is None
                   or abs(o1.obj_val - o2.obj_val) < 1e-8))

    print(json.dumps({
        "soak": "round3_close",
        "checks": CHECKS,
        "failures": FAILS,
        "wall_s": round(time.perf_counter() - t0, 1),
    }))


if __name__ == "__main__":
    main()
