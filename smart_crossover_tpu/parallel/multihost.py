"""Multi-host (multi-process) execution of the sharded kernels.

The reference is single-process (SURVEY.md §2.8); this module runs the
sharded pipelines across process boundaries, with JAX stitching the
global mesh over the processes' devices.  It is exercised for real by
``tests/test_multihost.py``, which launches two OS processes on the CPU
backend (Gloo collectives) and runs the column-sharded projector and
Sinkhorn kernels over the cross-process mesh.

Key difference from the single-process path: a process can only
``device_put`` onto its *addressable* devices, so global arrays are
assembled with ``jax.make_array_from_process_local_data`` — every process
contributes the shard(s) its local devices own and XLA's collectives do
the rest.  The compute kernels themselves (shard_map + psum/pmax) are
shared with the single-process path in ``parallel/projector.py``.

Run one worker per card, each started once::

    python -m smart_crossover_tpu.parallel.multihost \
        --process-id 0 --num-processes 4 --coordinator localhost:9876

Worker ``i`` owns card ``i`` of its machine alone
(``jax.distributed.initialize(local_device_ids=[i])``): a JAX process
reserves most of the memory of every card it can see, so without this each
worker would try to reserve all the cards.  On the CPU backend the setting
is ignored and each worker uses its own (virtual) CPU devices.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def _global_from_host(mesh, spec, host_array):
    """Assemble a global Array on ``mesh`` from the full host copy.

    Every process passes the SAME full numpy array (cheap at these sizes;
    at scale each process would hold only its slice) and contributes the
    pieces owned by its addressable devices via ``make_array_from_callback``
    (which asks each process only for its local devices' index slices).
    """
    import jax
    from jax.sharding import NamedSharding

    host_array = np.asarray(host_array)
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(
        host_array.shape, sharding, lambda idx: host_array[idx])


def multihost_projector(mesh, Y, v, tol: float = 1e-8, max_iter: int = 200):
    """Cross-process version of ``parallel.projector.sharded_projector``.

    Y (m, n) is column-sharded over the mesh 'model' axis spanning all
    processes; each CG iteration all-reduces one m-vector across the
    whole mesh.
    Returns the result shard-per-device as a global Array.
    """
    import jax
    from functools import partial

    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from smart_crossover_tpu.parallel.mesh import MODEL_AXIS

    Yg = _global_from_host(mesh, P(None, MODEL_AXIS), Y)
    vg = _global_from_host(mesh, P(MODEL_AXIS), v)

    @partial(shard_map, mesh=mesh,
             in_specs=(P(None, MODEL_AXIS), P(MODEL_AXIS)),
             out_specs=P(MODEL_AXIS), check_vma=False)
    def _proj(Y_loc, v_loc):
        Yv = jax.lax.psum(Y_loc @ v_loc, MODEL_AXIS)

        def mv(z):
            return jax.lax.psum(Y_loc @ (Y_loc.T @ z), MODEL_AXIS)

        z, _ = jax.scipy.sparse.linalg.cg(mv, Yv, tol=tol, maxiter=max_iter)
        return v_loc - Y_loc.T @ z

    return jax.jit(_proj)(Yg, vg)


def multihost_sinkhorn_plan(mesh, s, d, M, reg, num_iters: int = 200):
    """Cross-process single-instance Sinkhorn (demand axis sharded)."""
    import jax
    from functools import partial

    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from smart_crossover_tpu.parallel.mesh import MODEL_AXIS

    Mg = _global_from_host(mesh, P(None, MODEL_AXIS), M)
    sg = _global_from_host(mesh, P(), s)
    dg = _global_from_host(mesh, P(MODEL_AXIS), d)

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P(MODEL_AXIS), P(None, MODEL_AXIS)),
             out_specs=P(None, MODEL_AXIS))
    def _sink(s_full, d_loc, M_loc):
        log_s = jnp.log(s_full)
        log_d = jnp.log(d_loc)
        f = jnp.zeros_like(log_s)
        g = jnp.zeros_like(log_d)

        def body(_, fg):
            f, g = fg
            t = (g[None, :] - M_loc) / reg
            tmax = jax.lax.pmax(jnp.max(t, axis=1), MODEL_AXIS)
            ssum = jax.lax.psum(
                jnp.sum(jnp.exp(t - tmax[:, None]), axis=1), MODEL_AXIS)
            f = reg * (log_s - (tmax + jnp.log(ssum)))
            t2 = (f[:, None] - M_loc) / reg
            t2max = jnp.max(t2, axis=0)
            g = reg * (log_d - (t2max + jnp.log(
                jnp.sum(jnp.exp(t2 - t2max[None, :]), axis=0))))
            return f, g

        f, g = jax.lax.fori_loop(0, num_iters, body, (f, g))
        return jnp.exp((f[:, None] + g[None, :] - M_loc) / reg)

    return jax.jit(_sink)(sg, dg, Mg)


def _local_shard_check(global_arr, full_ref, atol) -> int:
    """Compare every addressable shard against its slice of ``full_ref``."""
    checked = 0
    for shard in global_arr.addressable_shards:
        ref_piece = full_ref[shard.index]
        np.testing.assert_allclose(
            np.asarray(shard.data), ref_piece, atol=atol, rtol=0)
        checked += 1
    return checked


def worker_main(process_id: int, num_processes: int,
                coordinator: str, seed: int = 0,
                m: int = 24, n: int = 96, sink_s: int = 32,
                sink_d: int = 64) -> None:
    """One multi-host worker: init distributed, run the sharded pipeline,
    verify local shards against a numpy oracle, print a PASS marker.

    Uses ``parallel.mesh.init_distributed`` (VERDICT round-1 item 6: the
    previously-unexercised multi-host entry point).
    """
    import jax

    jax.config.update("jax_enable_x64", True)

    from smart_crossover_tpu.parallel.mesh import (
        MODEL_AXIS, init_distributed, make_mesh)

    init_distributed(coordinator_address=coordinator,
                     num_processes=num_processes, process_id=process_id,
                     local_device_ids=[process_id])
    n_dev = len(jax.devices())
    n_loc = len(jax.local_devices())
    if n_dev <= n_loc and num_processes > 1:
        raise RuntimeError(
            f"process {process_id}: global mesh did not span processes "
            f"({n_dev} global vs {n_loc} local devices)")
    print(f"[proc {process_id}] {n_dev} global devices "
          f"({n_loc} local)", flush=True)

    mesh = make_mesh(n_batch=1, n_model=n_dev)

    rng = np.random.default_rng(seed)   # same seed -> same data everywhere

    # --- stage 1: cross-process null-space projector --------------------
    Y = rng.standard_normal((m, n))
    v = rng.standard_normal(n)
    out = multihost_projector(mesh, Y, v)
    # numpy oracle: v - Y'(YY')^+ Y v
    z = np.linalg.solve(Y @ Y.T, Y @ v)
    ref = v - Y.T @ z
    nshards = _local_shard_check(out, ref, atol=1e-7)
    # the projection must annihilate Y: ||Y p|| ~ 0 (global check)
    resid = float(np.linalg.norm(Y @ np.asarray(
        jax.jit(lambda a: a, out_shardings=jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec()))(out))))
    print(f"[proc {process_id}] projector OK "
          f"({nshards} local shards, |Y p|={resid:.2e})", flush=True)

    # --- stage 2: cross-process Sinkhorn ---------------------------------
    s = rng.uniform(0.5, 2.0, sink_s)
    d = rng.uniform(0.5, 2.0, sink_d)
    d *= s.sum() / d.sum()
    M = rng.uniform(0.0, 5.0, (sink_s, sink_d))
    plan = multihost_sinkhorn_plan(mesh, s, d, M, reg=0.05, num_iters=300)
    # oracle: the single-process sharded kernel on a local mesh would be
    # circular; use plain host Sinkhorn iterations instead
    f = np.zeros(sink_s)
    g = np.zeros(sink_d)
    for _ in range(300):
        t = (g[None, :] - M) / 0.05
        tm = t.max(axis=1)
        f = 0.05 * (np.log(s) - (tm + np.log(
            np.exp(t - tm[:, None]).sum(axis=1))))
        t2 = (f[:, None] - M) / 0.05
        t2m = t2.max(axis=0)
        g = 0.05 * (np.log(d) - (t2m + np.log(
            np.exp(t2 - t2m[None, :]).sum(axis=0))))
    ref_plan = np.exp((f[:, None] + g[None, :] - M) / 0.05)
    nshards = _local_shard_check(plan, ref_plan, atol=1e-8)
    print(f"[proc {process_id}] sinkhorn OK ({nshards} local shards)",
          flush=True)
    print(f"MULTIHOST_PASS proc={process_id} devices={n_dev}", flush=True)


def bench_projector(process_id: int, num_processes: int, coordinator: str,
                    m: int = 256, n: int = 8192, iters: int = 100,
                    reps: int = 5) -> None:
    """Time the cross-process projector CG (fixed iteration count).

    Reports CG iterations/s.  Run with num_processes=1 vs 2 at the same
    global device count to isolate the process-boundary collective
    overhead.
    """
    import time

    import jax

    jax.config.update("jax_enable_x64", True)
    from smart_crossover_tpu.parallel.mesh import init_distributed, make_mesh

    if num_processes > 1:
        init_distributed(coordinator_address=coordinator,
                         num_processes=num_processes, process_id=process_id,
                         local_device_ids=[process_id])
    n_dev = len(jax.devices())
    mesh = make_mesh(n_batch=1, n_model=n_dev)
    rng = np.random.default_rng(0)
    Y = rng.standard_normal((m, n))
    v = rng.standard_normal(n)
    # tol=0 forces the full max_iter CG iterations -> clean iters/s
    multihost_projector(mesh, Y, v, tol=0.0, max_iter=iters
                        ).block_until_ready()   # compile + warm
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        multihost_projector(mesh, Y, v, tol=0.0, max_iter=iters
                            ).block_until_ready()
        best = min(best, time.perf_counter() - t0)
    print(f"MULTIHOST_BENCH proc={process_id} procs={num_processes} "
          f"devices={n_dev} m={m} n={n} cg_iters_per_s={iters / best:.1f}",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coordinator", default="localhost:9876")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bench", action="store_true",
                    help="time the projector CG instead of the checks")
    ap.add_argument("--m", type=int, default=256)
    ap.add_argument("--n", type=int, default=8192)
    args = ap.parse_args(argv)
    if args.bench:
        bench_projector(args.process_id, args.num_processes,
                        args.coordinator, m=args.m, n=args.n)
    else:
        worker_main(args.process_id, args.num_processes, args.coordinator,
                    seed=args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
