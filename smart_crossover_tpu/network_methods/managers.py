"""Subproblem managers for the network crossover.

Same responsibilities as the reference's NetworkManager protocol and its two
implementations (reference net_manager.py:14-509): maintain the growing
column-generation subproblem, fix/free variables, big-M extension, basis and
solution recovery, and the optimality certificate.  The design differs where
a device-first structure helps:

* the MCF is arc-list primary, so "column slicing" is trivial array indexing
  and the big-M extension appends arcs instead of stacking sparse blocks;
* flow ranking runs as JAX segment/dense kernels (ops/ranking.py);
* subproblem solves go to the in-house warm-started network simplex instead
  of Gurobi/CPLEX/Mosek.
"""
from __future__ import annotations

from typing import Optional, Protocol, Tuple

import numpy as np

from smart_crossover_tpu.models import Basis, MinCostFlow, OptTransport, Output
from smart_crossover_tpu.ops.ranking import (
    mcf_flow_indicators,
    ot_flow_indicators,
    sort_flows,
)
from smart_crossover_tpu.parameters import (
    TOLERANCE_FOR_ARTIFICIAL_VARS,
    TOLERANCE_FOR_REDUCED_COSTS,
)
from smart_crossover_tpu.solvers.network_simplex import network_simplex
from smart_crossover_tpu.solvers.settings import SolverSettings


class NetworkManager(Protocol):
    """Structural interface used by column generation
    (parity with reference net_manager.py:14-113)."""

    m: int
    n: int
    basis: Basis

    def get_sorted_flows(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]: ...
    def recover_x_from_sub_x(self, x_sub: np.ndarray) -> np.ndarray: ...
    def recover_basis_from_sub_basis(self, basis_sub: Basis) -> Basis: ...
    def solve_subproblem(self, solver: str, settings: SolverSettings) -> Output: ...
    def recover_obj_val(self, obj_val: float) -> float: ...
    def check_optimality_condition(self, x: np.ndarray, y: np.ndarray) -> bool: ...
    def add_free_variables(self, ind_free: np.ndarray) -> None: ...
    def update_subproblem(self) -> None: ...
    def set_basis(self, basis: Basis) -> None: ...


def _solve_mcf_subproblem(mcf_sub: MinCostFlow, warm: Basis,
                          settings: SolverSettings) -> Output:
    res = network_simplex(mcf_sub, warm_basis=warm,
                          max_iter=settings.networkSimplexMaxIters)
    return Output(x=res.x, y=res.y, obj_val=res.obj_val, runtime=res.runtime,
                  iter_count=res.iter_count, rcost=res.rcost,
                  basis=res.basis, status=res.status)


class MCFManager:
    """Manager for general min-cost-flow crossover (CNET_MCF).

    Capability parity with reference MCFManagerStd (net_manager.py:116-319).
    """

    def __init__(self, mcf: MinCostFlow) -> None:
        self.mcf = mcf.copy()
        self.m = mcf.m
        self.n = mcf.n
        self.basis: Optional[Basis] = None
        self.artificial_vars = np.array([], dtype=np.int64)
        self.c_rescaling_factor: Optional[float] = None
        self._fix_low = np.array([], dtype=np.int64)
        self._fix_up = np.array([], dtype=np.int64)
        self._non_fix_mask = np.ones(self.n, dtype=bool)
        self.mcf_sub: Optional[MinCostFlow] = None

    # --- ranking ------------------------------------------------------------
    def get_sorted_flows(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        # pad the arc arrays to the next power of two so distinct instances
        # bucket onto the same compiled kernel (dummy self-loop arcs carry
        # zero flow and rank last)
        n = self.n
        n_pad = 1 << (n - 1).bit_length()
        xs = np.zeros(n_pad)
        xs[:n] = np.asarray(x)
        tails = np.zeros(n_pad, dtype=np.int64)
        heads = np.zeros(n_pad, dtype=np.int64)
        tails[:n] = self.mcf.tails
        heads[:n] = self.mcf.heads
        u = np.full(n_pad, np.inf)
        u[:n] = self.mcf.u
        m_pad = 1 << (self.m - 1).bit_length()  # bucket num_segments too
        ind = np.asarray(mcf_flow_indicators(xs, tails, heads, u, m_pad))
        queue = np.asarray(sort_flows(ind))
        queue = queue[queue < n]
        return queue, ind[:n]

    # --- cost rescaling -----------------------------------------------------
    def rescale_cost(self, factor: float) -> None:
        self.mcf.c = self.mcf.c / factor
        self.c_rescaling_factor = factor

    def recover_obj_val(self, obj_val: float) -> float:
        if self.c_rescaling_factor is None:
            return obj_val
        return obj_val * self.c_rescaling_factor

    def _artificial_tol(self) -> float:
        """Zero test for artificial flows, gated on the reference constant
        TOLERANCE_FOR_ARTIFICIAL_VARS (reference parameters.py:7) made
        *relative* to the total supply: supplies printed to ~8 significant
        digits carry at most 0.5e-8 * sum|b| net imbalance that only the
        big-M arcs can absorb, and 1e-8 * max(1, sum|b|) covers exactly
        that while rejecting anything materially infeasible."""
        return TOLERANCE_FOR_ARTIFICIAL_VARS * max(
            1.0, float(np.abs(self.mcf.b).sum()))

    def objective(self, x: np.ndarray) -> float:
        """True objective of a recovered full solution (includes the
        contribution of variables fixed at their upper bound, which the
        subproblem objective drops as a constant — reference
        net_manager.py:202-209 drops it too).  Sub-tolerance artificial
        flows (float roundoff of the supply vector) are treated as zero so
        the reported value is the original-arc cost, matching what
        network_simplex itself reports."""
        val = float(self.mcf.c @ x)
        art = self.artificial_vars
        if art.size:
            flows = x[art]
            small = flows < self._artificial_tol()
            val -= float(self.mcf.c[art][small] @ flows[small])
        if self.c_rescaling_factor is not None:
            val *= self.c_rescaling_factor
        return val

    # --- big-M extension ----------------------------------------------------
    def extend_by_bigM(self, bigM: float) -> None:
        """Append an artificial node plus one artificial arc per real node.

        As in reference net_manager.py:135-154: the artificial arc at node i
        is oriented by the sign of the residual supply ``b_true`` (b after
        discounting variables fixed at their upper bound), so the initial
        all-artificial basis is feasible.
        """
        m, n = self.m, self.n
        b_true = self.mcf.b.copy()
        if self._fix_up.size:
            ups = self.mcf.u[self._fix_up]
            np.add.at(b_true, self.mcf.tails[self._fix_up], ups)
            np.add.at(b_true, self.mcf.heads[self._fix_up], -ups)
        b_sign = np.where(b_true >= 0, 1.0, -1.0)
        art_node = m
        # sign +1: column has +1 at node i, -1 at the artificial node
        #   -> arc art_node -> i;  sign -1: arc i -> art_node.
        art_tails = np.where(b_sign > 0, art_node, np.arange(m))
        art_heads = np.where(b_sign > 0, np.arange(m), art_node)
        self.mcf = MinCostFlow(
            tails=np.concatenate([self.mcf.tails, art_tails]),
            heads=np.concatenate([self.mcf.heads, art_heads]),
            c=np.concatenate([self.mcf.c, np.full(m, bigM)]),
            u=np.concatenate([self.mcf.u, np.full(m, np.inf)]),
            b=np.concatenate([self.mcf.b, [0.0]]),
            name=self.mcf.name + "_bigM")
        self.artificial_vars = np.arange(n, n + m, dtype=np.int64)
        self._non_fix_mask = np.concatenate(
            [self._non_fix_mask, np.ones(m, dtype=bool)])

    # --- variable bookkeeping ----------------------------------------------
    def fix_variables(self, ind_fix_to_low: np.ndarray,
                      ind_fix_to_up: np.ndarray) -> None:
        self._fix_low = np.asarray(ind_fix_to_low, dtype=np.int64)
        self._fix_up = np.asarray(ind_fix_to_up, dtype=np.int64)
        self._non_fix_mask = np.ones(self.mcf.n, dtype=bool)
        self._non_fix_mask[self._fix_low] = False
        self._non_fix_mask[self._fix_up] = False

    def add_free_variables(self, ind_free_new: np.ndarray) -> None:
        ind = np.asarray(ind_free_new, dtype=np.int64)
        self._non_fix_mask[ind] = True
        keep = ~self._non_fix_mask
        self._fix_low = self._fix_low[keep[self._fix_low]]
        self._fix_up = self._fix_up[keep[self._fix_up]]

    @property
    def non_fix(self) -> np.ndarray:
        return np.where(self._non_fix_mask)[0]

    def update_subproblem(self) -> None:
        sel = self._non_fix_mask
        b_sub = self.mcf.b.copy()
        fix_up = self._fix_up
        if fix_up.size:
            ups = self.mcf.u[fix_up]
            np.add.at(b_sub, self.mcf.tails[fix_up], ups)
            np.add.at(b_sub, self.mcf.heads[fix_up], -ups)
        self.mcf_sub = MinCostFlow(
            tails=self.mcf.tails[sel], heads=self.mcf.heads[sel],
            c=self.mcf.c[sel], u=self.mcf.u[sel], b=b_sub,
            name=self.mcf.name + "_sub")

    # --- basis --------------------------------------------------------------
    def set_initial_basis(self) -> None:
        """All-artificial initial basis (reference net_manager.py:186-192)."""
        n_ext = self.mcf.n - self.artificial_vars.size
        vbasis = np.concatenate([
            -np.ones(n_ext, dtype=np.int32),
            np.zeros(self.artificial_vars.size, dtype=np.int32)])
        vbasis[self._fix_up] = -2
        cbasis = np.concatenate([-np.ones(self.m, dtype=np.int32), [0]])
        self.set_basis(Basis(vbasis, cbasis))

    def set_basis(self, basis: Basis) -> None:
        self.basis = basis

    def solve_subproblem(self, solver: str, settings: SolverSettings) -> Output:
        warm = Basis(self.basis.vbasis[self._non_fix_mask], self.basis.cbasis)
        return _solve_mcf_subproblem(self.mcf_sub, warm, settings)

    def recover_x_from_sub_x(self, x_sub: np.ndarray) -> np.ndarray:
        x = np.zeros(self.mcf.n)
        x[self._non_fix_mask] = x_sub
        x[self._fix_up] = self.mcf.u[self._fix_up]
        return x

    def recover_basis_from_sub_basis(self, basis_sub: Basis) -> Basis:
        vbasis = np.full(self.mcf.n, -1, dtype=np.int32)
        vbasis[self._non_fix_mask] = basis_sub.vbasis
        vbasis[self._fix_up] = -2
        return Basis(vbasis, basis_sub.cbasis)

    # --- optimality ---------------------------------------------------------
    def get_reduced_cost_for_original_mcf(self, y: np.ndarray) -> np.ndarray:
        rc = self.mcf.c - (y[self.mcf.heads] - y[self.mcf.tails])
        flip = self.basis.vbasis == -2
        rc[flip] = -rc[flip]
        return rc

    def check_optimality_condition(self, x: np.ndarray, y: np.ndarray) -> bool:
        art_ok = True
        if self.artificial_vars.size:
            art_ok = bool(np.all(
                x[self.artificial_vars] < self._artificial_tol()))
        rc_ok = bool(np.all(self.get_reduced_cost_for_original_mcf(y)
                            >= -TOLERANCE_FOR_REDUCED_COSTS))
        return art_ok and rc_ok


class OTManager:
    """Manager exploiting the dense bipartite structure of optimal transport
    (parity with reference OTManager, net_manager.py:322-509)."""

    def __init__(self, ot: OptTransport) -> None:
        self.ot = ot
        self.m = ot.s.size + ot.d.size
        self.n = ot.s.size * ot.d.size
        self.mask_sub = np.zeros((ot.s.size, ot.d.size), dtype=bool)
        self.artificial_vars = np.array([], dtype=np.int64)
        self.basis: Optional[Basis] = None
        self.mcf: Optional[MinCostFlow] = None

    def get_mcf(self) -> None:
        self.mcf = self.ot.to_MCF()

    def get_X(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(x).reshape(self.ot.s.size, self.ot.d.size)

    def get_sorted_flows(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        X = self.get_X(x)
        ind = np.asarray(ot_flow_indicators(X, self.ot.s, self.ot.d)).ravel()
        queue = np.asarray(sort_flows(ind))
        return queue, ind

    def extend_by_bigM(self, bigM: float) -> None:
        """Add an artificial supplier and destination with bigM arcs and a
        free corner arc (reference net_manager.py:381-400)."""
        ns, nd = self.ot.s.size, self.ot.d.size
        s_app = np.append(self.ot.s, np.sum(self.ot.d))
        d_app = np.append(self.ot.d, np.sum(self.ot.s))
        M_app = np.full((ns + 1, nd + 1), bigM)
        M_app[:ns, :nd] = self.ot.M
        M_app[ns, nd] = 0.0
        mask = np.zeros((ns + 1, nd + 1), dtype=bool)
        mask[:, nd] = True
        mask[ns, :] = True
        self.mask_sub = mask
        self.artificial_vars = np.where(mask.ravel())[0]
        self.ot = OptTransport(s_app, d_app, M_app, name=self.ot.name + "_bigM")
        self.m = ns + 1 + nd + 1
        self.n = (ns + 1) * (nd + 1)

    def add_free_variables(self, ind_free: np.ndarray) -> None:
        ind = np.asarray(ind_free, dtype=np.int64)
        if self.artificial_vars.size:
            # indices refer to the ORIGINAL (pre-extension) grid
            ns, nd = self.ot.s.size - 1, self.ot.d.size - 1
            rows, cols = np.unravel_index(ind, (ns, nd))
            self.mask_sub[rows, cols] = True
        else:
            flat = self.mask_sub.reshape(-1)
            flat[ind] = True

    def update_subproblem(self) -> None:
        pass  # mask-based: nothing to materialise until solve

    def set_initial_basis(self) -> None:
        vbasis = np.full(self.n, -1, dtype=np.int32)
        vbasis[self.artificial_vars] = 0
        cbasis = np.concatenate(
            [-np.ones(self.m - 1, dtype=np.int32), [0]])
        self.basis = Basis(vbasis, cbasis)

    def set_basis(self, basis: Basis) -> None:
        self.basis = basis

    def get_sub_problem(self) -> MinCostFlow:
        sel = self.mask_sub.reshape(-1)
        return MinCostFlow(
            tails=self.mcf.tails[sel], heads=self.mcf.heads[sel],
            c=self.mcf.c[sel], u=self.mcf.u[sel], b=self.mcf.b,
            name=self.ot.name + "_sub")

    def solve_subproblem(self, solver: str, settings: SolverSettings) -> Output:
        warm = Basis(self.basis.vbasis[self.mask_sub.reshape(-1)],
                     self.basis.cbasis)
        return _solve_mcf_subproblem(self.get_sub_problem(), warm, settings)

    def recover_x_from_sub_x(self, x_sub: np.ndarray) -> np.ndarray:
        x = np.zeros(self.n)
        x[self.mask_sub.reshape(-1)] = x_sub
        return x

    def recover_basis_from_sub_basis(self, basis_sub: Basis) -> Basis:
        vbasis = np.full(self.n, -1, dtype=np.int32)
        vbasis[self.mask_sub.reshape(-1)] = basis_sub.vbasis
        return Basis(vbasis, basis_sub.cbasis)

    def recover_obj_val(self, obj_val: float) -> float:
        return obj_val

    def _artificial_tol(self) -> float:
        # same relative TOLERANCE_FOR_ARTIFICIAL_VARS gate as MCFManager
        return TOLERANCE_FOR_ARTIFICIAL_VARS * max(
            1.0, float(np.abs(self.mcf.b).sum()))

    def objective(self, x: np.ndarray) -> float:
        val = float(self.mcf.c @ x)
        art = self.artificial_vars
        if art.size:
            flows = x[art]
            small = flows < self._artificial_tol()
            val -= float(self.mcf.c[art][small] @ flows[small])
        return val

    def get_reduced_cost_for_original_OT(self, y: np.ndarray) -> np.ndarray:
        return self.mcf.c - (y[self.mcf.heads] - y[self.mcf.tails])

    def check_optimality_condition(self, x: np.ndarray, y: np.ndarray) -> bool:
        art_ok = True
        if self.artificial_vars.size:
            # the free corner arc (last artificial) may carry flow
            art_ok = bool(np.all(
                x[self.artificial_vars][:-1] < self._artificial_tol()))
        rc_ok = bool(np.all(self.get_reduced_cost_for_original_OT(y)
                            >= -TOLERANCE_FOR_REDUCED_COSTS))
        return art_ok and rc_ok
