"""Device-backed normal-equations solver for the f64 IPM endgame.

The f64 endgame's per-iteration cost is the dense normal-equations
formation ``M = A D A'`` (2 m^2 n flops) plus an O(m^3) factorization,
while the *solves* it feeds only need to be f64-ACCURATE, not
f64-FACTORED.  This module forms and factors the Jacobi-equilibrated M in
f32 ON THE DEVICE (device GEMM + Cholesky), keeps the factor resident in
device memory, and drives each host-side solve to f64 accuracy by
iterative refinement:

* exact residuals are matrix-free f64 matvecs on the host,
  ``r = rhs - (A (d * (A' dy)) + reg * dy)``;
* corrections are device back-solves through the resident f32 factor.

IR contracts at ~kappa(S M S) * eps_f32 per pass; when it fails to
contract (late-mu conditioning blowup), the caller falls back to the
exact host f64 path for that iteration, so accuracy is never traded for
speed.  This replaces, for the single-big-LP path, the dense-NE inner
solver of the vendor barrier the reference shells out to
(reference solver_caller/caller.py:181-189) with a device-resident
factor.  Where the backend runs float64 (``DeviceNE.f64``) the factor and
solves are direct f64 on the device instead.
"""
from __future__ import annotations

import numpy as np


class DeviceNE:
    """Resident-factor f32 device solver for M = A diag(d) A' + reg I.

    Usage per IPM iteration::

        diag = ne.factor(d)              # device GEMM + Cholesky
        dy, ok = ne.solve(rhs, matvec)   # IR to f64 accuracy
        if not ok: <exact host fallback>
    """

    def __init__(self, A: np.ndarray, use_f64: bool | None = None):
        import jax
        import jax.numpy as jnp

        self._jax = jax
        self.m, self.n = A.shape
        self.A_dev = jax.device_put(np.asarray(A, dtype=np.float32))

        def factor(A_, d_, ridge):
            # HIGHEST: a default-precision f32 product may run in TF32
            # on the GPU — the factor's preconditioning quality (hence
            # the CG iteration count below) needs the full f32 product
            M = jnp.matmul(A_ * d_[None, :], A_.T,
                           precision=jax.lax.Precision.HIGHEST)
            diag = jnp.diagonal(M)
            s = jax.lax.rsqrt(jnp.maximum(diag, 1e-30))
            Ms = (s[:, None] * M) * s[None, :]
            Ms = Ms + ridge * jnp.eye(Ms.shape[0], dtype=Ms.dtype)
            L = jnp.linalg.cholesky(Ms)
            return L, s, diag, jnp.isfinite(jnp.diagonal(L)).all()

        def apply(L_, s_, r_):
            w = jax.scipy.linalg.cho_solve((L_, True), s_ * r_)
            return s_ * w

        self._factor = jax.jit(factor)
        self._apply = jax.jit(apply)
        self._L = None
        self._s = None
        # telemetry (read by benches/tests): cumulative counts + seconds
        self.stats = {"factors": 0, "solves": 0, "cg_iters": 0,
                      "fallbacks": 0, "f64_direct": 0, "factor_s": 0.0,
                      "apply_s": 0.0, "matvec_s": 0.0, "fails": []}

        # Native f64 on-device path, probed once per instance: a direct
        # f64 factor+solve has no late-mu stall mode, so it is preferred
        # wherever the backend runs f64.  The f32+CG scheme remains the
        # path for backends without usable f64.
        self.f64 = False
        self._A64 = self._M64 = self._L64 = None
        self._diag_scale = 1.0
        self._x64 = lambda: jax.enable_x64(True)
        if use_f64 is not False:
            try:
                with self._x64():
                    probe = jax.device_put(np.ones(4, np.float64))
                    ok = probe.dtype == np.float64 and float(
                        np.asarray(jnp.dot(probe, probe))) == 4.0
                self.f64 = bool(ok)
            except Exception:
                self.f64 = False
        if self.f64:
            def form64(A_, d_):
                M = jnp.matmul(A_ * d_[None, :], A_.T,
                               precision=jax.lax.Precision.HIGHEST)
                return M, jnp.diagonal(M)

            def factor64(M_, reg_):
                L = jnp.linalg.cholesky(
                    M_ + reg_ * jnp.eye(M_.shape[0], dtype=M_.dtype))
                return L, jnp.isfinite(jnp.diagonal(L)).all()

            def solve64(L_, r_):
                return jax.scipy.linalg.cho_solve((L_, True), r_)

            self._form64 = jax.jit(form64)
            self._factor64 = jax.jit(factor64)
            self._solve64 = jax.jit(solve64)
            with self._x64():
                self._A64 = jax.device_put(np.asarray(A, np.float64))

    def factor(self, d: np.ndarray, ridge: float = 1e-7,
               max_tries: int = 4) -> np.ndarray:
        """Form + factor on device; returns diag(A D A') as host f64.

        ``ridge`` is relative to the equilibrated unit diagonal; it only
        biases the *preconditioner* (the CG solve removes it from the
        solution), but it degrades preconditioning DIRECTLY — the
        preconditioned condition number is ~1 + ridge * kappa(S M S) —
        so it must sit at the f32 noise floor, not above it.  Starts a
        shade above eps_f32 and escalates 30x when the f32 Cholesky
        breaks down (late-mu numerically-indefinite-at-f32 cases).
        """
        import time as _time
        t0 = _time.perf_counter()
        if self.f64:
            # form M in f64 and defer the factorization to solve(),
            # which knows the caller's exact regularization
            try:
                with self._x64():
                    M, diag = self._form64(
                        self._A64,
                        self._jax.device_put(np.asarray(d, np.float64)))
                    self._M64, self._L64 = M, None
                    out = np.asarray(diag, dtype=np.float64)
                self._diag_scale = 1.0 + out.mean() + out.max()
                self.stats["factors"] += 1
                return out
            finally:
                self.stats["factor_s"] += _time.perf_counter() - t0
        d32 = np.asarray(d, dtype=np.float32)
        try:
            for _ in range(max_tries):
                L, s, diag, ok = self._factor(self.A_dev, d32,
                                              np.float32(ridge))
                if bool(ok):
                    self._L, self._s = L, s
                    self.stats["factors"] += 1
                    return np.asarray(diag, dtype=np.float64)
                ridge *= 30.0
            self._L = None
            raise FloatingPointError(
                "device f32 Cholesky failed at max ridge")
        finally:
            self.stats["factor_s"] += _time.perf_counter() - t0

    def apply(self, r: np.ndarray) -> np.ndarray:
        """One preconditioner application through the resident factor."""
        import time as _time
        t0 = _time.perf_counter()
        out = np.asarray(
            self._apply(self._L, self._s, np.asarray(r, np.float32)),
            dtype=np.float64)
        self.stats["apply_s"] += _time.perf_counter() - t0
        return out

    def _solve_direct64(self, rhs: np.ndarray, matvec, rel_tol: float,
                        reg: float) -> tuple[np.ndarray, bool]:
        """Direct f64 device factor+solve (+1 exact-IR pass).

        Factors the resident f64 M with the caller's exact ``reg``; on
        Cholesky breakdown the shift escalates 30x (relative to the
        diagonal scale) and the post-IR residual check decides whether
        the escalated factor still solved the exact system."""
        import time as _time
        rhs = np.asarray(rhs, dtype=np.float64)
        rhs_norm = np.linalg.norm(rhs)
        if rhs_norm == 0.0:
            return np.zeros_like(rhs), True
        self.stats["solves"] += 1
        self.stats["f64_direct"] += 1
        with self._x64():
            if self._L64 is None:
                t0 = _time.perf_counter()
                shift, ok = float(reg), False
                for _ in range(5):
                    L, okj = self._factor64(self._M64, np.float64(shift))
                    ok = bool(okj)
                    if ok:
                        break
                    shift = max(shift * 30.0,
                                1e-14 * self._diag_scale)
                self.stats["factor_s"] += _time.perf_counter() - t0
                if not ok:
                    self.stats["fallbacks"] += 1
                    self.stats["fails"].append(
                        {"best_res": float("inf"), "rel_tol": float(rel_tol),
                         "solve_idx": self.stats["solves"],
                         "f64_factor_breakdown": True})
                    return np.zeros_like(rhs), False
                self._L64 = L
            t0 = _time.perf_counter()
            dy = np.asarray(self._solve64(self._L64, rhs),
                            dtype=np.float64)
            self.stats["apply_s"] += _time.perf_counter() - t0
            t_mv = _time.perf_counter()
            r = rhs - matvec(dy)
            self.stats["matvec_s"] += _time.perf_counter() - t_mv
            t0 = _time.perf_counter()
            dy = dy + np.asarray(self._solve64(self._L64, r),
                                 dtype=np.float64)
            self.stats["apply_s"] += _time.perf_counter() - t0
            t_mv = _time.perf_counter()
            res = float(np.linalg.norm(rhs - matvec(dy))) / rhs_norm
            self.stats["matvec_s"] += _time.perf_counter() - t_mv
        ok = res <= rel_tol
        if not ok:
            self.stats["fallbacks"] += 1
            self.stats["fails"].append(
                {"best_res": float(res), "rel_tol": float(rel_tol),
                 "solve_idx": self.stats["solves"]})
        return dy, ok

    def solve(self, rhs: np.ndarray, matvec, rel_tol: float = 1e-11,
              max_iters: int = 30,
              reg: float | None = None) -> tuple[np.ndarray, bool]:
        """Preconditioned-CG solve of (exact f64) M dy = rhs — or, when
        the backend executes native f64 (``self.f64``), a direct f64
        device factor+solve (``reg`` then supplies the exact shift the
        caller folded into ``matvec``; without it the factor runs
        unshifted and relies on the IR residual check).

        ``matvec(v)`` must be the EXACT f64 operator (including any
        regularization term the caller added to M); the resident f32
        factor is the preconditioner.  CG's square-root dependence on
        the preconditioned condition number matters here: at late mu the
        f32 factor's Richardson contraction degrades to ~0.5/pass (f32
        formation error ~ kappa * eps32), where plain refinement needs
        20+ passes but CG still lands 1e-11 in ~15.  Returns
        ``(dy, converged)``; on stagnation the best iterate so far is
        returned with ``converged=False`` so the caller can fall back to
        the exact f64 host path.
        """
        import time as _time
        if self.f64 and self._M64 is not None:
            return self._solve_direct64(rhs, matvec, rel_tol,
                                        0.0 if reg is None else reg)
        rhs = np.asarray(rhs, dtype=np.float64)
        rhs_norm = np.linalg.norm(rhs)
        if rhs_norm == 0.0:
            return np.zeros_like(rhs), True
        self.stats["solves"] += 1
        dy = np.zeros_like(rhs)
        r = rhs.copy()
        z = self.apply(r)
        p_dir = z
        rz = float(r @ z)
        best_dy, best_res = dy, 1.0
        stall = 0
        for _ in range(max_iters):
            self.stats["cg_iters"] += 1
            t_mv = _time.perf_counter()
            q = matvec(p_dir)
            self.stats["matvec_s"] += _time.perf_counter() - t_mv
            pq = float(p_dir @ q)
            if pq <= 0.0 or not np.isfinite(pq):   # lost SPD in fp
                break
            alpha = rz / pq
            dy = dy + alpha * p_dir
            r = r - alpha * q
            rn = float(np.linalg.norm(r)) / rhs_norm
            if rn < best_res:
                best_dy, best_res, stall = dy, rn, 0
            else:
                stall += 1
                if stall >= 3:
                    break
            if rn <= rel_tol:
                return dy, True
            z = self.apply(r)
            rz_new = float(r @ z)
            p_dir = z + (rz_new / rz) * p_dir
            rz = rz_new
        ok = best_res <= rel_tol
        if not ok:
            self.stats["fallbacks"] += 1
            self.stats["fails"].append(
                {"best_res": float(best_res), "rel_tol": float(rel_tol),
                 "solve_idx": self.stats["solves"]})
        return best_dy, ok
