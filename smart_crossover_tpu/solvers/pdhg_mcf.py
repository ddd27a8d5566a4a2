"""Device-resident arc-list PDHG for min-cost flow.

The warm-start stage of the GOTO-17 flagship protocol (reference
scripts/run_network_crossover.py:38 — first-order warm start, then
crossover).  The incidence matvecs are built without gathers, from sorts
and reshapes (the design was shaped by a machine on which 1-D gathers
were scalar-addressed; whether ``segment_sum`` is as fast on the GPU is
not measured yet):

Layout: NODES are relabeled by degree and ARCS stored grouped by
(degree bucket, node) — "T-order" for tails, "H-order" for heads.  Every
node bucket of out-degree k is then an (m_k, k) MATRIX slice:

* segment-sum by tails = per-bucket reshape row-sums (no gathers at all);
* per-arc broadcast y[tail(a)] = per-bucket shape broadcasts;
* the head-side versions run in the in-degree node order plus one
  m-sized sort-permute back to the canonical node order.

The degree-REGULAR special case (real GOTO generator output) is one
bucket.

The PDHG itself reuses the validated restarted cores of solvers/pdhg.py
(adaptive PDLP and reflected-Halpern r2HPDHG) through an operator object
— only ``A @ x`` / ``A.T @ y`` change.
"""
from __future__ import annotations

import datetime
import time

import jax
import jax.numpy as jnp
import numpy as np


def _sort_apply(keys, z):
    """w[keys[p]] = z[p] for a permutation ``keys`` (device, via sort)."""
    _, w = jax.lax.sort((keys, z), dimension=0, num_keys=1)
    return w


def _inv_perm(p):
    inv = np.empty(p.size, dtype=np.int64)
    inv[p] = np.arange(p.size, dtype=np.int64)
    return inv


def _degree_buckets(cnt_sorted):
    """(nzero, ((k, m_k), ...)) from an ascending degree array."""
    degs, counts = np.unique(cnt_sorted, return_counts=True)
    nzero = int(counts[0]) if degs.size and degs[0] == 0 else 0
    buckets = tuple((int(k), int(mk)) for k, mk in zip(degs, counts)
                    if k > 0)
    return nzero, buckets


class IncidenceDeviceOp:
    """Gather-free node-arc incidence operator.

    Arc vectors live in T-order (grouped by out-degree bucket, then tail);
    node vectors live in N-order (nodes sorted by out-degree) — exposed as
    ``order_T`` and ``node_perm`` (``node_perm=None`` means the original
    node order, i.e. the degree-regular case).
    """

    def __init__(self, tails, heads, m: int, dtype=jnp.float32):
        tails = np.asarray(tails, dtype=np.int64)
        heads = np.asarray(heads, dtype=np.int64)
        n = tails.size
        self.shape = (m, n)
        self.dtype = dtype

        cnt_T0 = np.bincount(tails, minlength=m)
        cnt_H0 = np.bincount(heads, minlength=m)
        # degree-regular fast path (real GOTO output): one bucket, no node
        # relabeling, no head-side m-permutes
        regular = bool((cnt_T0 == cnt_T0[0]).all()
                       and (cnt_H0 == cnt_H0[0]).all())
        as_i32 = lambda a: jnp.asarray(a, jnp.int32)
        if regular:
            self.node_perm = None
            self._kt = int(cnt_T0[0])
            self._kh = int(cnt_H0[0])
            order_T = np.argsort(tails, kind="stable")
            hT = heads[order_T]
            order_H = np.argsort(hT, kind="stable")   # H-pos -> T-pos
            key_TH = _inv_perm(order_H)
            self.order_T = order_T
            self._key_TH = as_i32(key_TH)
            self._key_HT = as_i32(order_H)
            self._perm_HN = as_i32(np.zeros(1))       # unused
            self._rank_HN = as_i32(np.zeros(1))       # unused
            self._nzt = self._nzh = 0
            self._bt = ((self._kt, m),)
            self._bh = ((self._kh, m),)
            return

        self._kt = self._kh = None
        # N-space: nodes sorted by out-degree (stable)
        node_perm = np.argsort(cnt_T0, kind="stable")
        node_rank = _inv_perm(node_perm)
        self.node_perm = node_perm                    # N-pos -> original id
        tN = node_rank[tails]
        hN = node_rank[heads]
        order_T = np.argsort(tN, kind="stable")       # T-arc-pos -> orig arc
        self.order_T = order_T
        hT = hN[order_T]                              # per-T-arc head (N id)
        self._nzt, self._bt = _degree_buckets(cnt_T0[node_perm])

        # H-space: nodes sorted by in-degree (of the N-relabeled nodes)
        cntH_N = cnt_H0[node_perm]
        perm_HN = np.argsort(cntH_N, kind="stable")   # H-pos -> N-pos
        rank_HN = _inv_perm(perm_HN)                  # N-pos -> H-pos
        self._nzh, self._bh = _degree_buckets(cntH_N[perm_HN])

        h_rank = rank_HN[hT]                          # per-T-arc head H-pos
        order_H = np.argsort(h_rank, kind="stable")   # H-arc-pos -> T-arc-pos
        key_TH = _inv_perm(order_H)

        self._key_TH = as_i32(key_TH)
        self._key_HT = as_i32(order_H)
        self._perm_HN = as_i32(perm_HN)
        self._rank_HN = as_i32(rank_HN)

    # -- bucketed segment primitives (static shapes, no gathers) ------------

    def _bucket_segsum(self, z, buckets, nzero):
        parts = [jnp.zeros(nzero, z.dtype)] if nzero else []
        o = 0
        for k, mk in buckets:
            parts.append(z[o:o + mk * k].reshape(mk, k).sum(axis=1))
            o += mk * k
        return parts[0] if len(parts) == 1 else jnp.concatenate(parts)

    def _bucket_broadcast(self, y, buckets, nzero):
        parts = []
        o = nzero
        for k, mk in buckets:
            parts.append(jnp.broadcast_to(y[o:o + mk, None],
                                          (mk, k)).reshape(mk * k))
            o += mk
        return parts[0] if len(parts) == 1 else jnp.concatenate(parts)

    # -- operator interface (A @ x, A.T @ y) --------------------------------

    def __matmul__(self, x):
        # canonical incidence: +1 at heads, -1 at tails (models/formats.py
        # MinCostFlow: b is net inflow); node vectors in N-order
        tail_part = self._bucket_segsum(x, self._bt, self._nzt)
        xH = _sort_apply(self._key_TH, x)
        head_H = self._bucket_segsum(xH, self._bh, self._nzh)
        if self.node_perm is None:
            head_part = head_H            # regular: H node order == N order
        else:
            head_part = _sort_apply(self._perm_HN, head_H)
        return head_part - tail_part

    @property
    def T(self):
        return _IncidenceDeviceOpT(self)


class _IncidenceDeviceOpT:
    def __init__(self, op: IncidenceDeviceOp):
        self._op = op
        self.shape = (op.shape[1], op.shape[0])
        self.dtype = op.dtype

    def __matmul__(self, y):
        op = self._op
        yT = op._bucket_broadcast(y, op._bt, op._nzt)
        yH_nodes = y if op.node_perm is None \
            else _sort_apply(op._rank_HN, y)
        yH = op._bucket_broadcast(yH_nodes, op._bh, op._nzh)
        y_head_T = _sort_apply(op._key_HT, yH)
        return y_head_T - yT

    @property
    def T(self):
        return self._op


def _power_opnorm(op, n, dtype, iters: int = 30, seed: int = 0):
    v = jnp.asarray(np.random.default_rng(seed).standard_normal(n), dtype)

    def it(i, v):
        w = op.T @ (op @ v)
        return w / (jnp.linalg.norm(w) + 1e-30)

    v = jax.lax.fori_loop(0, iters, it, v)
    w = op @ v
    return jnp.sqrt(jnp.linalg.norm(op.T @ w)
                    / (jnp.linalg.norm(v) + 1e-30))


class _OpShell:
    """IncidenceDeviceOp view over traced arrays (inside jit)."""

    def __init__(self, fields, shape, dtype, static):
        (self._key_TH, self._key_HT, self._perm_HN,
         self._rank_HN) = fields
        self.shape = shape
        self.dtype = dtype
        # static = (regular, nzt, bt, nzh, bh)
        regular, self._nzt, self._bt, self._nzh, self._bh = static
        self.node_perm = None if regular else True   # only None-ness is used

    _bucket_segsum = IncidenceDeviceOp._bucket_segsum
    _bucket_broadcast = IncidenceDeviceOp._bucket_broadcast
    __matmul__ = IncidenceDeviceOp.__matmul__
    T = IncidenceDeviceOp.T


def _op_fields(op):
    return (op._key_TH, op._key_HT, op._perm_HN, op._rank_HN)


def _op_static(op):
    return (op.node_perm is None, op._nzt, op._bt, op._nzh, op._bh)


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("shape", "mode", "max_iters",
                                    "check_every", "restart_period",
                                    "static"))
def _run_device(fields, shape, b, c, l, u, x0, y0, mode, max_iters,
                check_every, restart_period, tol, static):
    """Jitted end-to-end run: same-shape instances (e.g. the 3-seed GOTO-17
    protocol) reuse one compilation."""
    from smart_crossover_tpu.solvers.pdhg import (
        _pdhg_core,
        _pdhg_core_halpern,
    )

    op = _OpShell(fields, shape, b.dtype, static)
    opnorm = _power_opnorm(op, shape[1], b.dtype)
    is_eq = jnp.ones(shape[0], dtype=bool)
    core = _pdhg_core_halpern if mode == "halpern" else _pdhg_core
    return core(op, b, c, l, u, is_eq, opnorm, x0, y0,
                max_iters=max_iters, check_every=check_every,
                restart_period=restart_period, tol=tol)


def pdhg_mcf_device(mcf, tol: float = 1e-4, max_iters: int = 5000,
                    mode: str = "halpern", dtype=jnp.float32,
                    check_every: int = 250, restart_period: int = 500,
                    x0=None, y0=None):
    """First-order warm-start engine for MCF on the accelerator.

    Returns (x, y, iters, converged, runtime) with x/y in the ORIGINAL
    arc/node order, f64 on host.
    """
    t0 = time.perf_counter()
    m, n = len(mcf.b), len(mcf.c)
    op = IncidenceDeviceOp(mcf.tails, mcf.heads, m, dtype=dtype)
    order = op.order_T
    nperm = op.node_perm
    c = jnp.asarray(np.asarray(mcf.c, np.float64)[order], dtype)
    u = jnp.asarray(np.asarray(mcf.u, np.float64)[order], dtype)
    l = jnp.zeros(n, dtype)
    b_np = np.asarray(mcf.b, np.float64)
    b = jnp.asarray(b_np if nperm is None else b_np[nperm], dtype)

    xs = (jnp.asarray(np.asarray(x0, np.float64)[order], dtype)
          if x0 is not None else jnp.clip(jnp.zeros(n, dtype), l, u))
    if y0 is not None:
        y_np = np.asarray(y0, np.float64)
        ys = jnp.asarray(y_np if nperm is None else y_np[nperm], dtype)
    else:
        ys = jnp.zeros(m, dtype)

    x, y, iters, done = _run_device(
        _op_fields(op), op.shape, b, c, l, u, xs, ys, mode, max_iters,
        check_every, restart_period, tol, static=_op_static(op))
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    x_out = np.empty(n, np.float64)
    x_out[order] = x
    if nperm is None:
        y_out = y
    else:
        y_out = np.empty(m, np.float64)
        y_out[nperm] = y
    runtime = datetime.timedelta(seconds=time.perf_counter() - t0)
    return x_out, y_out, int(iters), bool(done), runtime
