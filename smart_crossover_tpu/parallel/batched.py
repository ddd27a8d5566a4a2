"""Batched (vmapped) and mesh-sharded crossover pipelines.

The reference processes one instance at a time on one CPU
(SURVEY.md §2.8: no parallelism of any kind).  Here the whole TNET path —
Sinkhorn warm start, flow ranking, Borůvka MST, tree solve, irrigation push —
is a single jittable function that vmaps over an instance batch and shards
that batch axis over the device mesh.  Output is a *basic feasible* vertex
flow per instance plus its objective and an optimality bound; the exact
network-simplex cleanup (host) is optional and usually a no-op distance away.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from smart_crossover_tpu.network_methods.tree_bi import identify_tree_flows
from smart_crossover_tpu.ops.ranking import ot_flow_indicators
from smart_crossover_tpu.solvers.sinkhorn import (
    plan_from_potentials,
    round_to_feasible,
    sinkhorn_potentials,
)


def tnet_single(s, d, M, reg: float = 0.02, sinkhorn_iters: int = 200,
                tree_weights: str = "flow"):
    """One-instance TNET pipeline (jittable): Sinkhorn -> indicators ->
    MST -> tree solve -> push.  Returns (X_vertex, push_iters, obj).

    ``tree_weights='reduced_cost'`` builds the spanning tree from the
    Sinkhorn duals (prefer arcs with small reduced cost M - f - g) instead
    of the flow indicators — measured ~10-30% fewer exact-cleanup pivots;
    'flow' matches the reference's ranking semantics.
    """
    eps = reg * jnp.max(M)
    f, g = sinkhorn_potentials(s, d, M, eps, num_iters=sinkhorn_iters)
    Xs = round_to_feasible(plan_from_potentials(f, g, M, eps), s, d)
    if tree_weights == "reduced_cost":
        W = -(M - f[:, None] - g[None, :])
    else:
        W = ot_flow_indicators(Xs, s, d)
    X, push_iters = identify_tree_flows(W, s, d)
    obj = jnp.sum(X * M)
    return X, push_iters, obj


@partial(jax.jit, static_argnames=("reg", "sinkhorn_iters", "tree_weights"))
def batched_tnet(s, d, M, reg: float = 0.02, sinkhorn_iters: int = 200,
                 tree_weights: str = "flow"):
    """vmapped TNET over an instance batch: s (B,S), d (B,D), M (B,S,D)."""
    return jax.vmap(lambda a, b_, c_: tnet_single(a, b_, c_, reg,
                                                  sinkhorn_iters,
                                                  tree_weights))(s, d, M)


# Engine routing for engine='auto', measured on one NVIDIA H100 80GB HBM3
# at a 400 W power limit: seconds to certified optimal vertices, device
# stage (whole-batch vmap, median of 3) plus host certification, against
# the host native-core path end to end (median of 2).
#
#               parent   anc    packed   host
#   64 x 256^2   0.82    0.26    0.21    0.58
#   16 x 784^2   7.24    0.66    0.55    0.75
#
# 'packed' wins at both shapes.  The device path stops at 1024 a side,
# above the largest measured shape; bigger instances, a mesh, and the CPU
# backend go to the host core.
DEVICE_ENGINE = "packed"
DEVICE_MAX_SIDE = 1024


def auto_engine(S: int, D: int, mesh=None,
                accelerator: bool | None = None) -> str:
    """The pivot engine ``engine='auto'`` runs for an S x D batch.

    ``accelerator`` overrides the check of the default device (the CPU
    tests use it to exercise the table)."""
    if accelerator is None:
        from smart_crossover_tpu.config import on_accelerator

        accelerator = on_accelerator()
    if accelerator and mesh is None and max(S, D) <= DEVICE_MAX_SIDE:
        return DEVICE_ENGINE
    return "host"


def default_max_pivots(S: int, D: int) -> int:
    """Pivot cap of the device simplex: warm-started pivot counts grow
    about linearly in V = S + D (median ~1,000 at 784^2)."""
    return max(5000, 8 * (S + D))


def batched_tnet_exact(s, d, M, reg: float = 0.005,
                       sinkhorn_iters: int = 1000, mesh=None,
                       engine: str = "auto",
                       max_pivots: int | None = None):
    """Batched crossover to EXACT optimal vertices.

    ``engine='host'``: device does the heavy approximate work (the batched
    TNET pipeline); the host's native network simplex then cleans each
    instance up from the identified tree basis — usually a handful of
    pivots.  ``engine='device'`` (the 'packed' engine) or a specific device
    pivot engine ('parent', 'anc', 'packed', 'mask'): the whole solve,
    pivots included, stays on device.  Every device result is CERTIFIED on
    the host (exact f64 vertex + duals recomputed from the returned
    spanning-tree basis, reference acceptance test); instances that fail
    certification — e.g. f32 potential noise at 1024^2 depth leaves
    reduced costs at ~-4e-6 — are repaired by a warm-started native
    network simplex.  The returned
    vertices are therefore exact f64 regardless of device precision.
    ``engine='auto'`` takes :func:`auto_engine`'s choice.

    Returns (X, obj, cleanup_pivots, optimal_mask) as numpy arrays.
    """
    import numpy as np

    from smart_crossover_tpu.models import Basis, OptTransport
    from smart_crossover_tpu.solvers.network_simplex import network_simplex

    if engine == "auto":
        engine = auto_engine(*jnp.shape(M)[1:], mesh=mesh)
    if engine in ("device", "parent", "anc", "packed", "mask") \
            and mesh is None:
        from smart_crossover_tpu.network_methods.certify import (
            certify_ot_basis_batch,
        )

        dev_engine = "packed" if engine == "device" else engine
        if max_pivots is None:
            max_pivots = default_max_pivots(*np.shape(M)[1:])
        Xd, obj_d, push, piv, opt, Bm = batched_tnet_exact_device(
            s, d, M, reg=reg, sinkhorn_iters=sinkhorn_iters,
            engine=dev_engine, max_pivots=max_pivots)
        piv_n = np.asarray(piv, dtype=np.int64)
        opt_n = np.asarray(opt, dtype=bool)
        s64 = np.asarray(s, dtype=np.float64)
        d64 = np.asarray(d, dtype=np.float64)
        d64 = d64 * (s64.sum(1) / d64.sum(1))[:, None]  # f32 mass drift
        M64 = np.asarray(M, dtype=np.float64)
        certs = certify_ot_basis_batch(np.asarray(Bm), s64, d64, M64)
        Xn = np.stack([c.x for c in certs])
        obj_n = np.array([c.obj_val for c in certs])
        ok = opt_n & np.array([c.ok for c in certs])
        if ok.all():
            return Xn, obj_n, piv_n, ok
        # certification failures / pivot-capped instances: warm-start the
        # native core from the DEVICE basis (usually a handful of pivots)
        Bm_n = np.asarray(Bm)
        S, D = M64.shape[1:]
        for i in np.flatnonzero(~ok):
            ot = OptTransport(s=s64[i], d=d64[i], M=M64[i])
            mcf = ot.to_MCF()
            vbasis = np.where(Bm_n[i].ravel(), 0, -1).astype(np.int32)
            cbasis = np.concatenate([-np.ones(mcf.m - 1, dtype=np.int32),
                                     [0]])
            res = network_simplex(mcf, warm_basis=Basis(vbasis, cbasis))
            Xn[i] = res.x.reshape(S, D)
            obj_n[i] = res.obj_val
            piv_n[i] += res.iter_count
            ok[i] = res.status == "OPTIMAL"
        return Xn, obj_n, piv_n, ok

    if mesh is not None:
        X, push_iters, obj = sharded_batched_tnet(
            mesh, s, d, M, reg=reg, sinkhorn_iters=sinkhorn_iters)
    else:
        X, push_iters, obj = batched_tnet(s, d, M, reg=reg,
                                          sinkhorn_iters=sinkhorn_iters)
    X = np.asarray(X, dtype=np.float64)
    B, S, D = X.shape
    out_X = np.empty_like(X)
    out_obj = np.empty(B)
    pivots = np.empty(B, dtype=np.int64)
    optimal = np.zeros(B, dtype=bool)

    def cleanup(i: int) -> None:
        si = np.asarray(s[i], dtype=np.float64)
        di = np.asarray(d[i], dtype=np.float64)
        di = di * (si.sum() / di.sum())  # repair f32 mass-balance drift
        ot = OptTransport(s=si, d=di, M=np.asarray(M[i], dtype=np.float64))
        mcf = ot.to_MCF()
        vbasis = np.where(X[i].ravel() > 0, 0, -1).astype(np.int32)
        cbasis = np.concatenate([-np.ones(mcf.m - 1, dtype=np.int32), [0]])
        res = network_simplex(mcf, warm_basis=Basis(vbasis, cbasis))
        out_X[i] = res.x.reshape(S, D)
        out_obj[i] = res.obj_val
        pivots[i] = res.iter_count
        optimal[i] = res.status == "OPTIMAL"

    # the native core releases the GIL during the ctypes call, so threads
    # scale the host cleanup across cores
    import concurrent.futures as cf
    import os

    workers = min(max(os.cpu_count() or 1, 1), 8)
    if workers > 1 and B > 1:
        with cf.ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(cleanup, range(B)))
    else:
        for i in range(B):
            cleanup(i)
    return out_X, out_obj, pivots, optimal


def sharded_batched_tnet_exact_device(mesh, s, d, M, reg: float = 0.005,
                                      sinkhorn_iters: int = 1000,
                                      max_pivots: int = 5000,
                                      engine: str = "packed"):
    """Batch-shard the fully-device-resident EXACT pipeline (TNET warm
    start + transportation simplex to optimality) over the mesh 'batch'
    axis.  Each instance's work stays on its home device; the jitted step
    follows the inputs' batch sharding, so repeated calls reuse one
    compiled executable."""
    shard = NamedSharding(mesh, P("batch"))
    s, d, M = (jax.device_put(a, shard) for a in (s, d, M))
    return batched_tnet_exact_device(s, d, M, reg=reg,
                                     sinkhorn_iters=sinkhorn_iters,
                                     max_pivots=max_pivots, engine=engine)


def sharded_batched_tnet(mesh, s, d, M, reg: float = 0.02,
                         sinkhorn_iters: int = 200):
    """Shard the instance batch over the mesh 'batch' axis and run the
    jitted pipeline, which follows the inputs' sharding: XLA keeps each
    instance's work on its home device."""
    shard = NamedSharding(mesh, P("batch"))
    s, d, M = (jax.device_put(a, shard) for a in (s, d, M))
    return batched_tnet(s, d, M, reg=reg, sinkhorn_iters=sinkhorn_iters)


def _warm_basis(s, d, M, reg, sinkhorn_iters):
    """One instance's warm start for the device simplex: the TNET vertex
    and its support completed to a spanning-tree basis (Borůvka over the
    support indicator).  Returns (X0, basis_mask, push_iters)."""
    from smart_crossover_tpu.ops.mst import boruvka_bipartite_mst

    X0, push_iters, _ = tnet_single(s, d, M, reg, sinkhorn_iters)
    support = (X0 > 1e-12).astype(M.dtype)
    return X0, boruvka_bipartite_mst(support), push_iters


@partial(jax.jit, static_argnames=("reg", "sinkhorn_iters"))
def warm_start_bases(s, d, M, reg: float = 0.005, sinkhorn_iters: int = 1000):
    """The warm-start stage of :func:`batched_tnet_exact_device` alone,
    vmapped over the batch (for timing the stages apart)."""
    return jax.vmap(lambda a, b_, c_: _warm_basis(a, b_, c_, reg,
                                                  sinkhorn_iters))(s, d, M)


@partial(jax.jit, static_argnames=("reg", "sinkhorn_iters", "max_pivots",
                                   "engine"))
def batched_tnet_exact_device(s, d, M, reg: float = 0.005,
                              sinkhorn_iters: int = 1000,
                              max_pivots: int = 5000,
                              engine: str = "packed"):
    """EXACT batched OT crossover, fully device-resident.

    The TNET pipeline identifies a feasible tree vertex per instance; its
    support is completed to a spanning-tree basis (Borůvka over the support
    indicator) and the batched device transportation simplex pivots to
    optimality — no host round trip.

    ``engine='packed'`` (default; the fastest measured, see the routing
    table above :func:`auto_engine`) keeps each root path as a packed
    bitmask row (ops/transport_simplex_packed.py).  ``engine='parent'``
    uses the parent-array/binary-lifting simplex
    (ops/transport_simplex_parent.py): O(V log V) gathers per pivot plus
    one dense pricing pass.  ``engine='anc'`` uses the ancestor-matrix
    simplex (ops/transport_simplex_anc.py): incremental root-path algebra,
    O(V^2) bool elementwise per pivot.  ``engine='mask'`` keeps the
    original dense-propagation implementation (ops/transport_simplex.py)
    as the correctness oracle.

    The whole batch is one vmap: measured on the H100, splitting it into
    sequential lax.map chunks was 3.9-7x slower at 64 x 256^2 and
    16 x 784^2 (the engines' state is a few MB per instance).

    Returns (X, obj, push_iters, pivots, optimal_mask, basis_mask);
    the (B, S, D) boolean basis_mask is the final spanning-tree basis,
    from which network_methods.certify recomputes the exact f64 vertex.
    """
    from smart_crossover_tpu.ops.transport_simplex import transport_simplex
    from smart_crossover_tpu.ops.transport_simplex_anc import (
        transport_simplex_anc,
    )
    from smart_crossover_tpu.ops.transport_simplex_packed import (
        transport_simplex_packed,
    )
    from smart_crossover_tpu.ops.transport_simplex_parent import (
        transport_simplex_parent,
    )

    pivot_fn = {"parent": transport_simplex_parent,
                "anc": transport_simplex_anc,
                "packed": transport_simplex_packed,
                "mask": transport_simplex}.get(engine)

    def one(s_, d_, M_):
        X0, Bm, push_iters = _warm_basis(s_, d_, M_, reg, sinkhorn_iters)
        X, Bm2, pivots, optimal = pivot_fn(
            X0, Bm, M_, s_, d_, max_pivots=max_pivots)
        return X, jnp.sum(X * M_), push_iters, pivots, optimal, Bm2

    return jax.vmap(one)(jnp.asarray(s), jnp.asarray(d), jnp.asarray(M))
