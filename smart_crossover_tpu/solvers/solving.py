"""Solver facade: solve_lp / solve_mcf / solve_ot.

Drop-in capability replacement for the reference's solver_caller layer
(reference solver_caller/solving.py:13-133 plus the Gurobi/CPLEX/Mosek
adapters): same entry points, same method names, same warm-start plumbing and
Output contract — but every method dispatches to the in-house engines:

* 'barrier'            -> Mehrotra IPM (+ simplex crossover when
                          settings.crossover == 'on', like vendor barrier)
* 'simplex' / 'primal_simplex' / 'default'
                       -> bounded-variable revised primal simplex
* 'dual_simplex'       -> true dual simplex when a dual-feasible warm basis
                          is supplied (primal fallback otherwise)
* 'first_order'/'pdhg' -> restarted PDHG (device; dense or BCOO sparse)
* 'network_simplex'    -> warm-started network simplex (MCF/OT)
* 'sinkhorn'           -> entropic first-order plan (OT only)

The 'GRB'/'CPL'/'MSK' solver names are accepted for migration compatibility
and all map to the in-house backend.
"""
from __future__ import annotations

import datetime
import logging
from typing import Optional, Tuple, Union

import numpy as np
from scipy.sparse import issparse as sp_issparse

from smart_crossover_tpu.models import (
    Basis,
    GeneralLP,
    MinCostFlow,
    OptTransport,
    Output,
    StandardLP,
)
from smart_crossover_tpu.solvers.ipm import ipm_general_lp, ipm_solve
from smart_crossover_tpu.solvers.network_simplex import network_simplex
from smart_crossover_tpu.solvers.settings import SolverSettings
from smart_crossover_tpu.solvers.simplex import (
    ST_BASIC,
    ST_LOWER,
    ST_UPPER,
    primal_simplex,
)

logger = logging.getLogger(__name__)

_KNOWN_BACKENDS = ("JAX", "GRB", "CPL", "MSK")


def _check_backend(solver: str) -> None:
    if solver not in _KNOWN_BACKENDS:
        raise ValueError(
            f"Unknown solver {solver!r}; choose from {_KNOWN_BACKENDS} "
            "(all names dispatch to the in-house JAX backend).")


def _as_general(lp: Union[GeneralLP, StandardLP]) -> GeneralLP:
    if isinstance(lp, GeneralLP):
        return lp
    if isinstance(lp, StandardLP):
        return lp.to_general()
    raise ValueError("Invalid LP format: expected GeneralLP or StandardLP.")


# --------------------------------------------------------------------------
# basis <-> simplex status conversion (standard slack-augmented space)
# --------------------------------------------------------------------------
def _basis_to_vstatus(lp: GeneralLP, basis: Basis) -> np.ndarray:
    le_rows = np.where(lp.sense == "<")[0]
    vst = np.empty(lp.n + le_rows.size, dtype=np.int8)
    vst[:lp.n] = basis.vbasis
    # slack of row i: basic iff cbasis[i] == 0, else at lower (row tight)
    vst[lp.n:] = np.where(basis.cbasis[le_rows] == 0, ST_BASIC, ST_LOWER)
    return vst


def _vstatus_to_basis(lp: GeneralLP, vstatus: np.ndarray,
                      row_basic: np.ndarray) -> Basis:
    le_rows = np.where(lp.sense == "<")[0]
    vbasis = vstatus[:lp.n].astype(np.int32)
    cbasis = np.full(lp.m, -1, dtype=np.int32)
    cbasis[le_rows[vstatus[lp.n:] == ST_BASIC]] = 0
    cbasis[row_basic] = 0  # artificial (logical) basic on this row
    return Basis(vbasis, cbasis)


def _crossover_statuses(x, l, u, ctol: float = 1e-7) -> np.ndarray:
    """Classify an interior solution into simplex statuses (the in-house
    analog of a vendor barrier crossover start): variables hugging a bound
    become nonbasic at that bound, everything else is proposed basic and the
    simplex basis repair + phase-1/2 finishes the job."""
    st = np.full(x.size, ST_BASIC, dtype=np.int8)
    dl = x - l
    du = u - x
    near = ctol * (1.0 + np.abs(x))
    at_l = np.isfinite(l) & (dl <= du) & (dl < near)
    at_u = np.isfinite(u) & (du < dl) & (du < near)
    st[at_l] = ST_LOWER
    st[at_u] = ST_UPPER
    st[~np.isfinite(l) & ~np.isfinite(u)] = ST_BASIC
    return st


# --------------------------------------------------------------------------
# LP solve
# --------------------------------------------------------------------------
def solve_lp(lp: Union[GeneralLP, StandardLP],
             solver: str = "JAX",
             method: str = "default",
             settings: SolverSettings | None = None,
             warm_start_basis: Optional[Basis] = None,
             warm_start_solution: Optional[Tuple[np.ndarray, np.ndarray]] = None,
             ) -> Output:
    """Solve an LP (signature parity with reference solving.py:71-94)."""
    _check_backend(solver)
    if settings is None:
        settings = SolverSettings()
    glp = _as_general(lp)
    _check_finite_lp(glp)

    out = None
    offset_applied = False
    if (settings.presolve == "on" and warm_start_basis is None
            and warm_start_solution is None
            and method in ("default", "simplex", "primal_simplex",
                           "dual_simplex", "barrier", "first_order",
                           "pdhg")):
        # real presolve, matching the reference's vendor Presolve knob
        # (reference caller.py:17-41 / filehandling.py:62-74); only takes
        # over when it actually removes something, and never when a warm
        # start pins the caller to the original index space
        out = _solve_lp_presolved(glp, solver, method, settings)
        offset_applied = out is not None
    if out is not None:
        pass
    elif method == "barrier":
        out = _solve_lp_barrier(glp, settings, warm_start_solution)
    elif method in ("barrier_perturb", "perturb", "smart_crossover"):
        # the framework's own crossover: barrier + optimal-face estimation +
        # seeded objective perturbation + warm simplex finish (reference
        # lp_methods/algorithms.py:18-265).  Much cheaper than the plain
        # snap-and-clean crossover when the optimal face is large.  Lazy
        # import: lp_methods.algorithms itself calls back into solve_lp for
        # its internal barrier solves (with the plain crossover, so this
        # dispatch cannot recurse).
        from smart_crossover_tpu.lp_methods.algorithms import (
            run_perturb_algorithm,
        )

        out = run_perturb_algorithm(glp, solver=solver,
                                    barrierTol=settings.barrierTol,
                                    optimalityTol=settings.optimalityTol,
                                    log_file=settings.log_file)
        # run_perturb_algorithm's internal solve_lp calls (and its direct-BFS
        # path) already include glp.obj_offset in every returned obj_val
        offset_applied = True
    elif method in ("default", "simplex", "primal_simplex", "dual_simplex"):
        out = _solve_lp_simplex(glp, settings, warm_start_basis,
                                warm_start_solution,
                                dual=(method == "dual_simplex"))
    elif method in ("first_order", "pdhg"):
        from smart_crossover_tpu.solvers.pdhg import pdhg_general_lp

        x0 = y0 = None
        if warm_start_solution is not None:
            x0, y0 = warm_start_solution
        res = pdhg_general_lp(glp, tol=settings.barrierTol,
                              max_iters=settings.firstOrderMaxIters,
                              x0=x0, y0=y0, mode=settings.fomMode)
        out = Output(x=res.x, y=res.y, x_bar=res.x, obj_val=res.obj_val,
                     runtime=res.runtime, bar_iter_count=res.iter_count,
                     rcost=glp.get_dual_slack(res.y), status=res.status)
        if res.status != "OPTIMAL":
            # PDHG has no divergence detection at all (VERDICT.md item 4):
            # a large stuck primal residual or runaway iterates are the
            # 'suspect' triggers for exact certification
            suspect = (res.primal_residual > 1e-4
                       or np.abs(res.x).max(initial=0.0) > 1e8
                       or np.abs(res.y).max(initial=0.0) > 1e8)
            cert_out = _certify_failure(glp, res.runtime, res.iter_count,
                                        settings, suspect)
            if cert_out is not None:
                out = cert_out
    if out is not None:
        if glp.obj_offset and out.obj_val is not None and not offset_applied:
            from dataclasses import replace as _replace

            out = _replace(out, obj_val=out.obj_val + glp.obj_offset)
        from smart_crossover_tpu.utils.logging import log_solve

        log_solve(settings.log_file, solver, method, name=glp.name,
                  status=out.status, obj_val=out.obj_val,
                  runtime=out.runtime, iter_count=out.iter_count,
                  bar_iter_count=out.bar_iter_count)
        return out
    raise ValueError(
        "Invalid method. Choose from 'default', 'barrier', "
        "'barrier_perturb'/'perturb'/'smart_crossover', 'simplex', "
        "'primal_simplex', 'dual_simplex', 'network_simplex', "
        "'first_order'/'pdhg'.")


def _check_finite_lp(glp: GeneralLP) -> None:
    """Reject non-finite problem data up front: NaN/inf in A, b or c would
    otherwise grind through a solver to a confusing NUMERICAL_ERROR."""
    data = glp.A.data if sp_issparse(glp.A) else np.asarray(glp.A)
    if not (np.all(np.isfinite(data)) and np.all(np.isfinite(glp.b))
            and np.all(np.isfinite(glp.c))):
        raise ValueError("LP data contains NaN/inf entries (A, b or c); "
                         "bounds l/u may be infinite but not NaN")
    if np.any(np.isnan(glp.l)) or np.any(np.isnan(glp.u)):
        raise ValueError("LP bounds contain NaN entries")


def _solve_lp_presolved(glp: GeneralLP, solver: str, method: str,
                        settings: SolverSettings) -> Optional[Output]:
    """Presolve the LP, solve the reduction, and lift the answer back.

    Returns None when presolve removes nothing (the plain path runs), an
    INFEASIBLE/UNBOUNDED Output when presolve proves it, and otherwise the
    postsolved Output in the original index space: primal via
    PresolveInfo.postsolve_x, duals via PresolveInfo.postsolve_y (exact dual
    reconstruction for dropped singleton rows), basis extended with fixed
    columns nonbasic and dropped rows logically basic."""
    from dataclasses import replace as _replace

    from smart_crossover_tpu.solvers.presolve import (
        PresolveError,
        presolve_lp,
    )

    try:
        red, info = presolve_lp(glp)
    except PresolveError as e:
        return Output(runtime=datetime.timedelta(0), status=e.status)
    if red.n == glp.n and red.m == glp.m:
        return None
    if red.n == 0:
        x = info.fixed_values.copy()
        obj = float(glp.c @ x) + glp.obj_offset
        y = info.postsolve_y(np.zeros(0), glp)
        return Output(x=x, y=y, obj_val=obj, rcost=glp.get_dual_slack(y),
                      runtime=datetime.timedelta(0), iter_count=0,
                      status="OPTIMAL")
    out = solve_lp(red, solver=solver, method=method,
                   settings=_replace(settings, presolve="off"))
    if out.x is None:
        if (out.status in ("INFEASIBLE", "UNBOUNDED")
                and (out.farkas_ray is not None
                     or out.unbounded_ray is not None)):
            # the ray certifies the REDUCED problem; re-classify the
            # original LP so the returned ray lives in its row/column space
            cert_out = _certify_failure(glp, out.runtime,
                                        out.bar_iter_count, settings, True)
            if cert_out is not None:
                return cert_out
        return Output(runtime=out.runtime, status=out.status,
                      iter_count=out.iter_count,
                      bar_iter_count=out.bar_iter_count)
    x = info.postsolve_x(out.x)
    y = None
    rcost = None
    if out.y is not None:
        y = info.postsolve_y(out.y, glp)
        rcost = glp.get_dual_slack(y)
    basis = None
    if out.basis is not None:
        vbasis = np.full(glp.n, -1, dtype=np.int32)
        vbasis[info.kept_cols] = out.basis.vbasis
        cbasis = np.zeros(glp.m, dtype=np.int32)
        cbasis[info.kept_rows] = out.basis.cbasis
        # a singleton-row fix pins x_j = b_i/a_ij, possibly strictly
        # interior -- the exact structural lift makes column j basic in
        # the dropped '=' row i (not nonbasic-at-lower, which would
        # reconstruct x_j = l_j and break warm starts)
        if info.singleton_fixes:
            for i, j in info.singleton_fixes:
                vbasis[j] = 0
                cbasis[i] = -1
        basis = Basis(vbasis, cbasis)
    x_bar = info.postsolve_x(out.x_bar) if out.x_bar is not None else None
    obj = float(glp.c @ x) + glp.obj_offset
    return _replace(out, x=x, y=y, x_bar=x_bar, obj_val=obj, rcost=rcost,
                    basis=basis)


# exact INFEASIBLE/UNBOUNDED certification is an elastic-LP simplex solve;
# cap the instances it auto-runs on (beyond this the heuristic status stands)
_CERTIFY_MAX_NNZ = 400_000
_CERTIFY_MAX_DIM = 40_000


def _certify_failure(glp: GeneralLP, runtime, bar_iter_count,
                     settings: SolverSettings,
                     suspect: bool) -> Optional[Output]:
    """Upgrade a heuristic IPM/PDHG failure to an exactly certified
    INFEASIBLE/UNBOUNDED Output carrying a *verifiable* ray (solvers/rays.py)
    — replacing the round-1 iterate-magnitude guesswork (VERDICT.md item 4).

    Returns None when certification is off/gated, the LP is actually
    feasible and bounded (the caller's own failure status stands), or the
    extraction hit a numerical inconsistency."""
    if settings.certify == "off" or (settings.certify == "auto"
                                     and not suspect):
        return None
    A_std = glp.get_standard_A()
    nnz = A_std.nnz if sp_issparse(A_std) else int(np.prod(A_std.shape))
    m, n = A_std.shape
    if nnz > _CERTIFY_MAX_NNZ or m + n > _CERTIFY_MAX_DIM:
        return None
    from smart_crossover_tpu.solvers.rays import classify_lp

    l_std, u_std = glp.get_standard_bounds()
    try:
        cert = classify_lp(A_std, glp.b, glp.get_standard_c(), l_std, u_std)
    except RuntimeError:
        logger.warning("exact feasibility classification failed; keeping "
                       "the heuristic failure status")
        return None
    if cert.status == "INFEASIBLE":
        return Output(runtime=runtime, status="INFEASIBLE",
                      bar_iter_count=bar_iter_count,
                      farkas_ray=cert.farkas_ray)
    if cert.status == "UNBOUNDED":
        # slice the standard-space recession direction back to the original
        # columns (slack components encode the '<' row slack movement)
        return Output(runtime=runtime, status="UNBOUNDED",
                      bar_iter_count=bar_iter_count,
                      unbounded_ray=cert.unbounded_ray[:glp.n])
    return None


def _solve_lp_barrier(glp: GeneralLP, settings: SolverSettings,
                      warm_start_solution=None) -> Output:
    x0 = y0 = None
    if warm_start_solution is not None:
        x0, y0 = warm_start_solution
    res = ipm_general_lp(glp, tol=settings.barrierTol,
                         max_iter=settings.barrierMaxIters, x0=x0, y0=y0)
    status = res.status
    if status in ("STALLED", "ITERATION_LIMIT") and res.x is not None:
        # the IPM returns its best iterate; if it is moderately feasible it
        # is still a usable interior point for crossover purposes
        pres = (np.linalg.norm(glp.get_primal_slack(res.x)[glp.sense == "="])
                / (1.0 + np.linalg.norm(glp.b)))
        if np.isfinite(pres) and pres < 1e-5:
            status = "NEAR_OPTIMAL"
    if status not in ("OPTIMAL", "NEAR_OPTIMAL"):
        # diverging iterates (or an explicit INFEASIBLE/UNBOUNDED guess)
        # are the 'suspect' trigger for exact certification; covers the
        # free-variable-heavy unbounded LPs that exit as ITERATION_LIMIT
        # (STATUS.md round-1 limitation #6)
        xmag = (np.abs(res.x).max(initial=0.0)
                if res.x is not None else np.inf)
        ymag = (np.abs(res.y).max(initial=0.0)
                if res.y is not None else np.inf)
        suspect = (status in ("INFEASIBLE", "UNBOUNDED", "NUMERICAL_ERROR")
                   or max(xmag, ymag) > 1e8)
        cert_out = _certify_failure(glp, res.runtime, res.iter_count,
                                    settings, suspect)
        if cert_out is not None:
            return cert_out
        return Output(runtime=res.runtime, status=res.status,
                      bar_iter_count=res.iter_count)
    x_bar = res.x
    if settings.crossover != "on":
        rcost = glp.get_dual_slack(res.y)
        return Output(x=x_bar, y=res.y, x_bar=x_bar, obj_val=res.obj_val,
                      runtime=res.runtime, iter_count=0,
                      bar_iter_count=res.iter_count, rcost=rcost,
                      status=status)

    # crossover: classify the interior point, then simplex-clean to a vertex
    A_std = glp.get_standard_A()
    c_std = glp.get_standard_c()
    l_std, u_std = glp.get_standard_bounds()
    x_std = glp.get_standard_x(x_bar)
    vst = _crossover_statuses(x_std, l_std, u_std)
    # crossover cleanup defaults to Dantzig when simplexPricing is unset: on
    # the massively degenerate all-basic starts a vendor-style crossover
    # produces, Devex pays +1 BTRAN and +1 pricing matvec per pivot for no
    # pivot reduction (measured 139 s vs 90 s at 31k pivots on a 6k x 26k
    # cover instance — same pivot count to 0.4%).  An explicit
    # simplexPricing='SE' still buys Devex here.
    cx_pricing = "devex" if settings.simplexPricing == "SE" else "dantzig"
    sres = primal_simplex(A_std, glp.b, c_std, l_std, u_std, vstatus=vst,
                          max_iter=settings.simplexMaxIters,
                          tol=settings.optimalityTol,
                          time_limit=settings.timeLimit,
                          pricing=cx_pricing)
    basis = _vstatus_to_basis(glp, sres.vstatus, sres.row_basic)
    runtime = res.runtime + sres.runtime
    if sres.status != "OPTIMAL":
        # the simplex finisher's INFEASIBLE/UNBOUNDED is an exact
        # determination; attach the verifiable ray for parity with the
        # vendor Farkas duals
        cert_out = _certify_failure(
            glp, runtime, res.iter_count, settings,
            suspect=sres.status in ("INFEASIBLE", "UNBOUNDED"))
        if cert_out is not None:
            return cert_out
        return Output(runtime=runtime, status=sres.status,
                      bar_iter_count=res.iter_count, iter_count=sres.iter_count)
    # the simplex cleanup certifies exact optimality regardless of whether
    # the barrier stopped at OPTIMAL or NEAR_OPTIMAL
    return Output(x=sres.x[:glp.n], y=sres.y, x_bar=x_bar,
                  obj_val=float(glp.c @ sres.x[:glp.n]),
                  runtime=runtime, iter_count=sres.iter_count,
                  bar_iter_count=res.iter_count, rcost=sres.rcost[:glp.n],
                  basis=basis, status="OPTIMAL")


def _pricing(settings: SolverSettings) -> str:
    # 'SE' (steepest edge) -> Devex; 'PP' (partial pricing) -> plain Dantzig;
    # default: Devex (roughly 2x fewer pivots measured)
    return "dantzig" if settings.simplexPricing == "PP" else "devex"


def _solve_lp_simplex(glp: GeneralLP, settings: SolverSettings,
                      warm_start_basis: Optional[Basis],
                      warm_start_solution, dual: bool = False) -> Output:
    A_std = glp.get_standard_A()
    c_std = glp.get_standard_c()
    l_std, u_std = glp.get_standard_bounds()
    vst = None
    if warm_start_basis is not None:
        vst = _basis_to_vstatus(glp, warm_start_basis)
    elif warm_start_solution is not None:
        x0 = np.asarray(warm_start_solution[0])
        vst = _crossover_statuses(glp.get_standard_x(x0), l_std, u_std)
    if dual and vst is not None:
        from smart_crossover_tpu.solvers.simplex import dual_simplex

        sres = dual_simplex(A_std, glp.b, c_std, l_std, u_std, vstatus=vst,
                            max_iter=settings.simplexMaxIters,
                            tol=settings.optimalityTol)
    else:
        sres = primal_simplex(A_std, glp.b, c_std, l_std, u_std, vstatus=vst,
                              max_iter=settings.simplexMaxIters,
                              tol=settings.optimalityTol,
                              time_limit=settings.timeLimit,
                              pricing=_pricing(settings))
    basis = _vstatus_to_basis(glp, sres.vstatus, sres.row_basic)
    if sres.status != "OPTIMAL":
        cert_out = _certify_failure(
            glp, sres.runtime, None, settings,
            suspect=sres.status in ("INFEASIBLE", "UNBOUNDED"))
        if cert_out is not None:
            from dataclasses import replace as _replace

            return _replace(cert_out, iter_count=sres.iter_count)
        return Output(runtime=sres.runtime, status=sres.status,
                      iter_count=sres.iter_count)
    return Output(x=sres.x[:glp.n], y=sres.y,
                  obj_val=float(glp.c @ sres.x[:glp.n]),
                  runtime=sres.runtime, iter_count=sres.iter_count,
                  rcost=sres.rcost[:glp.n], basis=basis, status="OPTIMAL")


# --------------------------------------------------------------------------
# MCF / OT solve
# --------------------------------------------------------------------------
def solve_mcf(mcf: MinCostFlow,
              solver: str = "JAX",
              method: str = "default",
              settings: SolverSettings | None = None,
              warm_start_basis: Optional[Basis] = None) -> Output:
    """Solve a min-cost-flow problem (parity with reference solving.py:97-113)."""
    _check_backend(solver)
    if settings is None:
        settings = SolverSettings()
    if method in ("default", "network_simplex", "simplex", "primal_simplex",
                  "dual_simplex"):
        res = network_simplex(mcf, warm_basis=warm_start_basis,
                              max_iter=settings.networkSimplexMaxIters,
                              time_limit=settings.timeLimit)
        from smart_crossover_tpu.utils.logging import log_solve

        log_solve(settings.log_file, solver, method, name=mcf.name,
                  status=res.status, obj_val=res.obj_val,
                  runtime=res.runtime, iter_count=res.iter_count)
        if res.status != "OPTIMAL":
            return Output(runtime=res.runtime, status=res.status,
                          iter_count=res.iter_count)
        return Output(x=res.x, y=res.y, obj_val=res.obj_val,
                      runtime=res.runtime, iter_count=res.iter_count,
                      rcost=res.rcost, basis=res.basis, status=res.status)
    if method in ("first_order", "pdhg"):
        # matrix-free PDHG as the explicit first-order engine (the paper's
        # algorithms accept FOM warm starts); barrier requests are NOT
        # rerouted here — the IPM's tree-preconditioned PCG handles large
        # graph Laplacians directly (solvers/laplacian.py)
        from jax.experimental import sparse as jsparse

        from smart_crossover_tpu.solvers.pdhg import pdhg_solve

        import scipy.sparse as ssp

        A_b = jsparse.BCOO.from_scipy_sparse(ssp.csr_matrix(mcf.A))
        # active-set polish only when the FOM pair IS the final product
        # (no crossover, tight tol): for warm starts it spends minutes of
        # LSMR at GOTO-17 scale sharpening a point the network simplex
        # re-certifies anyway
        fom_final = (settings.crossover != "on"
                     and settings.barrierTol <= 1e-6)
        res = pdhg_solve(A_b, mcf.b, mcf.c, np.zeros(mcf.n), mcf.u,
                         tol=max(settings.barrierTol, 1e-7),
                         max_iters=settings.firstOrderMaxIters,
                         polish=fom_final)
        out_interior = Output(x=res.x, y=res.y, x_bar=res.x,
                              obj_val=res.obj_val, runtime=res.runtime,
                              bar_iter_count=res.iter_count,
                              status=res.status)
        if settings.crossover != "on" or res.status != "OPTIMAL":
            return out_interior
        ns = network_simplex(mcf, max_iter=settings.networkSimplexMaxIters)
        return Output(x=ns.x, y=ns.y, x_bar=res.x, obj_val=ns.obj_val,
                      runtime=res.runtime + ns.runtime,
                      iter_count=ns.iter_count,
                      bar_iter_count=res.iter_count, rcost=ns.rcost,
                      basis=ns.basis, status=ns.status)
    if method == "barrier":
        l = np.zeros(mcf.n)
        res = ipm_solve(mcf.A, mcf.b, mcf.c, l, mcf.u,
                        tol=settings.barrierTol)
        out_interior = Output(x=res.x, y=res.y, x_bar=res.x,
                              obj_val=res.obj_val, runtime=res.runtime,
                              bar_iter_count=res.iter_count,
                              status=res.status)
        # NEAR_OPTIMAL interior points still cross over: the network-simplex
        # finisher certifies exactness regardless (same policy as
        # _solve_lp_barrier's simplex cleanup)
        if settings.crossover != "on" or res.status not in (
                "OPTIMAL", "NEAR_OPTIMAL"):
            return out_interior
        ns = network_simplex(mcf, max_iter=settings.networkSimplexMaxIters)
        return Output(x=ns.x, y=ns.y, x_bar=res.x, obj_val=ns.obj_val,
                      runtime=res.runtime + ns.runtime,
                      iter_count=ns.iter_count,
                      bar_iter_count=res.iter_count, rcost=ns.rcost,
                      basis=ns.basis, status=ns.status)
    raise ValueError(f"Invalid method {method!r} for MCF.")


def solve_ot(ot: OptTransport,
             solver: str = "JAX",
             method: str = "default",
             settings: SolverSettings | None = None,
             warm_start_basis: Optional[Basis] = None) -> Output:
    """Solve an optimal transport problem (parity with solving.py:116-133)."""
    _check_backend(solver)
    if settings is None:
        settings = SolverSettings()
    if method == "sinkhorn":
        import time

        from smart_crossover_tpu.solvers.sinkhorn import sinkhorn

        t0 = time.perf_counter()
        x = sinkhorn(ot, reg=settings.sinkhornReg,
                     num_iters=settings.firstOrderMaxIters)
        rt = datetime.timedelta(seconds=time.perf_counter() - t0)
        # entropic-regularised plan: feasible in the marginals but NOT an
        # LP-optimal vertex — report it as such so downstream status checks
        # can tell it from an exact solve
        return Output(x=x, x_bar=x, obj_val=float(ot.M.ravel() @ x),
                      runtime=rt, status="APPROXIMATE",
                      bar_iter_count=settings.firstOrderMaxIters)
    if method == "device_simplex":
        # fully device-resident exact solve (TNET identification + batched
        # transportation simplex); see ops/transport_simplex.py
        import time

        import numpy as _np

        from smart_crossover_tpu.parallel.batched import (
            batched_tnet_exact_device,
        )

        t0 = time.perf_counter()
        X, obj, push, piv, opt, Bm = batched_tnet_exact_device(
            ot.s[None], ot.d[None], ot.M[None],
            reg=settings.sinkhornReg, sinkhorn_iters=1000,
            engine=settings.deviceSimplexEngine)
        status = "OPTIMAL" if bool(_np.asarray(opt)[0]) else "ITERATION_LIMIT"
        # the device pivots in backend precision (f32 by default); the
        # returned VERTEX is recomputed exactly on the host from the
        # spanning-tree basis and certified under the reference test
        from smart_crossover_tpu.network_methods.certify import (
            certify_ot_basis,
        )

        cert = certify_ot_basis(_np.asarray(Bm[0]), ot.s, ot.d, ot.M)
        rt = datetime.timedelta(seconds=time.perf_counter() - t0)
        if cert.ok:
            return Output(x=cert.x.ravel(), obj_val=cert.obj_val,
                          runtime=rt,
                          iter_count=int(piv[0]) + int(push[0]),
                          status=status)
        return Output(x=_np.asarray(X[0], dtype=_np.float64).ravel(),
                      obj_val=float(obj[0]), runtime=rt,
                      iter_count=int(piv[0]) + int(push[0]),
                      status="NEAR_OPTIMAL" if status == "OPTIMAL"
                      else status)
    return solve_mcf(ot.to_MCF(), solver=solver, method=method,
                     settings=settings, warm_start_basis=warm_start_basis)
