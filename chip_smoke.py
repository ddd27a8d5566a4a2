#!/usr/bin/env python
"""Run the system's main paths once on one GPU, at full size, and check them.

Phases, in order, each printing one line of findings:

0. the device (JAX's platform, kind and count, read by a child process so
   that the card stays free for phase 2) and the card's name and power
   limit from ``nvidia-smi``;
1. build the native network-simplex core and load it;
2. the card-only tests, ``pytest -m gpu``, in a child process, before this
   process touches the card;
3. the certified batched OT crossover, ``batched_tnet_exact(engine="auto")``
   at 64 x 256^2 and 16 x 784^2 (f32 on the device): every instance
   certified, 4 objectives against a cold native network simplex;
4. single-instance ``network_crossover`` (tnet, cnet_ot) at 784^2 against
   the native core;
5. ``pdhg_solve`` (adaptive, halpern) on a dense 512 x 2048 LP and
   ``run_perturb_algorithm`` on a generated sparse LP, against HiGHS;
6. ``ipm_fleet`` on 64 x (256 x 512) and ``ipm_big`` at 1000 x 4000 (the
   device f64 normal-equations path), against HiGHS.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``,
printed only when every phase passed.  Any failure exits non-zero.

Usage::

    python chip_smoke.py                # one card, every phase
    python chip_smoke.py --four-cards   # only the sharded paths, four cards
    python chip_smoke.py --rehearse     # tiny sizes on the CPU (a harness
                                        # check; it measures nothing)
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import bench  # noqa: E402  (fails outside a checkout, as it should)
import smart_crossover_tpu as scx  # noqa: E402


class PhaseFailed(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class Sizes:
    ot_shapes: tuple          # (B, S, D, seed) per fleet shape
    sinkhorn_iters: int
    reps: int                 # steady-state repetitions per timing
    n_compare: int            # instances checked against the cold core
    nc_side: int              # phase 4 instance side
    pdhg_shape: tuple         # phase 5 dense LP (m, n)
    perturb_lp: dict          # phase 5 data/lp_gen.random_sparse_lp kwargs
    fleet: tuple              # phase 6 (B, m, n)
    big: tuple                # phase 6 ipm_big (m, n)
    four_batch: tuple         # four-card OT batch (B, S, D, seed)


FULL = Sizes(ot_shapes=((64, 256, 256, 0), (16, 784, 784, 1)),
             sinkhorn_iters=1000, reps=5, n_compare=4, nc_side=784,
             pdhg_shape=(512, 2048),
             perturb_lp=dict(m=600, n=2000, density=0.01, seed=0),
             fleet=(64, 256, 512), big=(1000, 4000),
             four_batch=(64, 256, 256, 0))
REHEARSE = Sizes(ot_shapes=((4, 12, 12, 0), (2, 16, 16, 1)),
                 sinkhorn_iters=200, reps=2, n_compare=2, nc_side=12,
                 pdhg_shape=(12, 50),
                 perturb_lp=dict(m=30, n=90, density=0.1, seed=0),
                 fleet=(4, 8, 20), big=(10, 40),
                 four_batch=(8, 16, 16, 0))
REG = 0.005                   # the exact-fleet warm-start regularisation


def report(phase, **fields) -> None:
    print(f"[phase {phase}] " + json.dumps(fields, default=_jsonable),
          flush=True)


def _jsonable(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    return str(v)


def check(cond, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


def rel(a, b) -> float:
    return abs(a - b) / max(1.0, abs(b))


def _wall(fn, reps):
    """(compile-run seconds, median steady seconds, result): every run
    ends in block_until_ready."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return first, float(np.median(times)), out


def _peak_bytes(dev=None):
    import jax

    dev = dev or jax.devices()[0]
    return (dev.memory_stats() or {}).get("peak_bytes_in_use")


def _memory_analysis(compiled) -> dict:
    ma = compiled.memory_analysis()
    if ma is None:
        return {}
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k: getattr(ma, k) for k in keys if hasattr(ma, k)}


# ---------------------------------------------------------------- phases

def phase0_device(sizes: Sizes, rehearse: bool) -> dict:
    """Device check in a child, so that this process leaves the card free
    for the pytest child of phase 2."""
    probe = subprocess.run(
        [sys.executable, "-c",
         "import json, jax; d = jax.devices()[0]; print(json.dumps("
         "{'platform': d.platform, 'kind': d.device_kind, "
         "'count': len(jax.devices()), 'jax': jax.__version__}))"],
        capture_output=True, text=True, timeout=300)
    check(probe.returncode == 0,
          f"JAX device probe failed: {probe.stderr[-2000:]}")
    dev = json.loads(probe.stdout.strip().splitlines()[-1])
    if not rehearse:
        check(dev["platform"] == "gpu",
              f"no GPU: JAX's default platform is {dev['platform']!r} "
              "(pass --rehearse for a CPU rehearsal)")
    card = bench.card_name_and_power()
    report(0, **dev, card=card)
    return dev


def phase1_native(sizes: Sizes, rehearse: bool, out=None) -> None:
    from smart_crossover_tpu.native import native_available
    from smart_crossover_tpu.native.build import build

    t0 = time.perf_counter()
    path = build(verbose=False, out=out)
    if out is None:
        ok = native_available()
    else:      # rehearsal: built elsewhere, so check that it loads
        import ctypes

        ok = ctypes.CDLL(str(path)) is not None
    check(ok, "the native network-simplex core did not load")
    report(1, built=os.path.basename(str(path)),
           build_s=time.perf_counter() - t0, native_available=ok)


def phase2_card_tests(sizes: Sizes, rehearse: bool) -> None:
    env = dict(os.environ, JAX_PLATFORMS="cpu" if rehearse else "cuda")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
         "-p", "no:cacheprovider", "-p", "no:randomly", "tests/"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    tail = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    counts = {k: int(n) for n, k in re.findall(
        r"(\d+) (passed|failed|skipped|error|errors|deselected)", tail)}
    check(r.returncode == 0,
          f"pytest -m gpu failed (rc={r.returncode}):\n{r.stdout[-4000:]}"
          f"\n{r.stderr[-2000:]}")
    if not rehearse:
        check(counts.get("passed", 0) > 0 and not counts.get("skipped"),
              f"card tests did not all run on the card: {tail}")
    report(2, summary=tail, seconds=time.perf_counter() - t0)


def phase3_ot_fleet(sizes: Sizes, rehearse: bool) -> None:
    import jax

    from smart_crossover_tpu.network_methods.certify import (
        certify_ot_basis_batch,
    )
    from smart_crossover_tpu.parallel.batched import (
        auto_engine,
        batched_tnet_exact,
        batched_tnet_exact_device,
        default_max_pivots,
        warm_start_bases,
    )
    from smart_crossover_tpu.solvers.network_simplex import network_simplex

    iters = sizes.sinkhorn_iters
    for (B, S, D, seed) in sizes.ot_shapes:
        # f64 host data; the device computes on its f32 cast (x64 off)
        s, d, M = bench.make_batch(B, S, D, seed=seed)
        engine = auto_engine(S, D)
        # the rehearsal's CPU routes to the host core; run the device
        # engine there so that the rehearsal covers its checks
        entry_engine = "auto"
        if rehearse and engine == "host":
            engine = entry_engine = auto_engine(S, D, accelerator=True)
        compile_s, wall_s, (X, obj, piv, ok) = _wall(
            lambda: batched_tnet_exact(s, d, M, reg=REG,
                                       sinkhorn_iters=iters,
                                       engine=entry_engine),
            sizes.reps)
        check(bool(np.all(ok)), f"{B}x{S}^2: not every instance optimal")
        line = dict(shape=f"{B}x{S}x{D}", engine=engine,
                    compile_s=compile_s, steady_wall_s=wall_s,
                    instances_per_s=B / wall_s,
                    median_pivots=float(np.median(piv)))
        if engine != "host":
            max_piv = default_max_pivots(S, D)

            def device_step():
                return batched_tnet_exact_device(
                    s, d, M, reg=REG, sinkhorn_iters=iters,
                    max_pivots=max_piv, engine=engine)

            _, dev_s, out = _wall(device_step, sizes.reps)
            Bm = np.asarray(out[5])
            t0 = time.perf_counter()
            certs = certify_ot_basis_batch(Bm, s, d, M)
            cert_s = time.perf_counter() - t0
            bad = [c.reason for c in certs if not c.ok]
            check(not bad, f"{B}x{S}^2: {len(bad)} device bases failed "
                           f"certification: {bad[:3]}")
            _, warm_s, _ = _wall(
                lambda: warm_start_bases(s, d, M, reg=REG,
                                         sinkhorn_iters=iters), sizes.reps)
            piv_dev = np.asarray(out[3])
            loop_s = max(dev_s - warm_s, 1e-12)
            compiled = batched_tnet_exact_device.lower(
                s, d, M, reg=REG, sinkhorn_iters=iters, max_pivots=max_piv,
                engine=engine).compile()
            line.update(
                device_stage_s=dev_s, warm_start_s=warm_s,
                pivot_loop_s=dev_s - warm_s, certify_s=cert_s,
                all_certified=True,
                max_feas_err=max(c.max_feas_err for c in certs),
                min_reduced_cost=min(c.min_rcost for c in certs),
                loop_iterations=int(piv_dev.max()),
                pivots_per_s=float(piv_dev.sum()) / loop_s,
                per_pivot_wall_us=loop_s / max(int(piv_dev.max()), 1) * 1e6,
                memory_analysis=_memory_analysis(compiled))
        for i in range(min(sizes.n_compare, B)):
            ot = scx.OptTransport(s=s[i], d=d[i], M=M[i])
            ref = network_simplex(ot.to_MCF())
            check(ref.status == "OPTIMAL", "cold native core not optimal")
            check(rel(obj[i], ref.obj_val) <= 1e-9,
                  f"{B}x{S}^2 instance {i}: {obj[i]!r} vs cold native "
                  f"{ref.obj_val!r}")
        line.update(compared_with_native=min(sizes.n_compare, B),
                    peak_bytes_in_use=_peak_bytes())
        report(3, **line)


def phase4_network_crossover(sizes: Sizes, rehearse: bool) -> None:
    from smart_crossover_tpu.solvers.network_simplex import network_simplex
    from smart_crossover_tpu.solvers.sinkhorn import sinkhorn

    S = sizes.nc_side
    s, d, M = bench.make_batch(1, S, S, seed=2)
    ot = scx.OptTransport(s=s[0], d=d[0], M=M[0])
    t0 = time.perf_counter()
    x = sinkhorn(ot, num_iters=sizes.sinkhorn_iters)
    sink_s = time.perf_counter() - t0
    ref = network_simplex(ot.to_MCF())
    check(ref.status == "OPTIMAL", "cold native core not optimal")
    line = dict(side=S, sinkhorn_s=sink_s)
    for method in ("tnet", "cnet_ot"):
        t0 = time.perf_counter()
        out = scx.network_crossover(x=x, ot=ot, method=method)
        wall = time.perf_counter() - t0
        check(out.status == "OPTIMAL", f"{method}: status {out.status}")
        gap = rel(out.obj_val, ref.obj_val)
        check(gap <= 1e-9, f"{method}: objective off by {gap:.2e}")
        line[method] = dict(wall_s=wall, rel_gap=gap)
    line.update(peak_bytes_in_use=_peak_bytes())
    report(4, **line)


def phase5_general_lp(sizes: Sizes, rehearse: bool) -> None:
    from scipy.optimize import linprog

    from smart_crossover_tpu.data.lp_gen import random_sparse_lp
    from smart_crossover_tpu.solvers.pdhg import pdhg_solve

    m, n = sizes.pdhg_shape
    rng = np.random.default_rng(5)
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    b = A @ rng.uniform(0.2, 0.8, n)
    c = A.T @ rng.standard_normal(m) + np.abs(rng.standard_normal(n)) + 0.05
    ref = linprog(c, A_eq=A, b_eq=b, bounds=[(0, 2)] * n, method="highs")
    check(ref.status == 0, "HiGHS failed on the PDHG LP")
    tol = 1e-6
    # f32 device data; every product at Precision.HIGHEST
    # (config.full_precision_matmuls), so no TF32 error enters the gap
    line = dict(pdhg_shape=f"{m}x{n}", tol=tol, device_dtype="float32",
                matmul_precision="highest")
    for mode in ("adaptive", "halpern"):
        t0 = time.perf_counter()
        res = pdhg_solve(A.astype(np.float32), b, c, np.zeros(n),
                         np.full(n, 2.0), tol=tol, max_iters=100_000,
                         mode=mode)
        wall = time.perf_counter() - t0
        gap = rel(res.obj_val, ref.fun)
        check(gap <= 10 * tol, f"pdhg {mode}: gap {gap:.2e} > {10 * tol}")
        line[mode] = dict(wall_s=wall, status=res.status,
                          iters=res.iter_count, rel_gap=gap)
    lp = random_sparse_lp(**sizes.perturb_lp)
    eq = lp.sense == "="
    Ad = lp.A.toarray()
    ref = linprog(lp.c, A_eq=Ad[eq], b_eq=lp.b[eq], A_ub=Ad[~eq],
                  b_ub=lp.b[~eq], method="highs",
                  bounds=[(lo if np.isfinite(lo) else None,
                           hi if np.isfinite(hi) else None)
                          for lo, hi in zip(lp.l, lp.u)])
    check(ref.status == 0, "HiGHS failed on the perturbation LP")
    t0 = time.perf_counter()
    out = scx.run_perturb_algorithm(lp)
    wall = time.perf_counter() - t0
    check(out.status == "OPTIMAL", f"perturbation crossover: {out.status}")
    gap = rel(out.obj_val, ref.fun)
    check(gap < 1e-8, f"perturbation crossover: gap {gap:.2e}")
    line["perturb"] = dict(shape=f"{lp.A.shape[0]}x{lp.A.shape[1]}",
                           wall_s=wall, rel_gap=gap)
    line.update(peak_bytes_in_use=_peak_bytes())
    report(5, **line)


def _dense_lp(rng, m, n):
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    b = A @ rng.uniform(0.2, 0.8, n)
    c = A.T @ rng.standard_normal(m) + np.abs(rng.standard_normal(n)) * 0.1
    return A, b, c + 0.01


def phase6_ipm(sizes: Sizes, rehearse: bool) -> None:
    from scipy.optimize import linprog

    from smart_crossover_tpu.solvers import ipm_fleet as fleet

    Bf, m, n = sizes.fleet
    rng = np.random.default_rng(6)
    As = rng.standard_normal((Bf, m, n)) / np.sqrt(m)
    bs = np.einsum("bmn,bn->bm", As, rng.uniform(0.2, 0.8, (Bf, n)))
    cs = rng.standard_normal((Bf, n))
    lo, up = np.zeros((Bf, n)), np.ones((Bf, n))
    t0 = time.perf_counter()
    res = fleet.ipm_fleet(As, bs, cs, lo, up, tol=1e-8)
    wall = time.perf_counter() - t0
    check(all(st == "OPTIMAL" for st in res.status), "fleet not optimal")
    for i in range(min(4, Bf)):
        ref = linprog(cs[i], A_eq=As[i], b_eq=bs[i], bounds=[(0, 1)] * n,
                      method="highs")
        check(rel(res.obj[i], ref.fun) <= 1e-6,
              f"fleet instance {i}: {res.obj[i]!r} vs HiGHS {ref.fun!r}")
    # one call, compile included: the host f64 endgame dominates it
    line = dict(fleet=f"{Bf}x({m}x{n})", wall_s=wall,
                device_s=res.device_s, endgame_s=res.endgame_s)
    m, n = sizes.big
    A, b, c = _dense_lp(np.random.default_rng(7), m, n)
    # the device f64 normal equations are the non-CPU default at
    # m*n >= 4e6 (solvers/ipm_fleet.py); the rehearsal forces them on
    env_key = "SCX_DEVICE_ENDGAME"
    old = os.environ.get(env_key)
    if rehearse:
        os.environ[env_key] = "1"
    try:
        t0 = time.perf_counter()
        big = fleet.ipm_big(A, b, c, np.zeros(n), np.ones(n), tol=1e-8)
        big_s = time.perf_counter() - t0
    finally:
        if rehearse:
            if old is None:
                os.environ.pop(env_key, None)
            else:
                os.environ[env_key] = old
    ref = linprog(c, A_eq=A, b_eq=b, bounds=[(0, 1)] * n, method="highs")
    check(big.status == "OPTIMAL", f"ipm_big: {big.status}")
    check(rel(big.obj_val, ref.fun) <= 1e-6,
          f"ipm_big: {big.obj_val!r} vs HiGHS {ref.fun!r}")
    stats = fleet.last_ne_stats or {}
    line.update(big=f"{m}x{n}", big_wall_s=big_s, big_device_s=big.device_s,
                big_endgame_s=big.endgame_s,
                big_rel_gap=rel(big.obj_val, ref.fun),
                ne_stats={k: stats.get(k) for k in ("f64_direct", "fallbacks",
                                                    "solves", "factors")},
                peak_bytes_in_use=_peak_bytes())
    report(6, **line)


def phase_four_cards(sizes: Sizes, rehearse: bool) -> None:
    """The batch-sharded OT fleet and the column-sharded ipm_big on a
    four-device mesh, each against the same call on one device."""
    import jax
    from scipy.optimize import linprog

    from smart_crossover_tpu.network_methods.certify import (
        certify_ot_basis_batch,
    )
    from smart_crossover_tpu.parallel import make_mesh
    from smart_crossover_tpu.parallel.batched import (
        auto_engine,
        batched_tnet_exact_device,
        default_max_pivots,
        sharded_batched_tnet_exact_device,
    )
    from smart_crossover_tpu.solvers.ipm_fleet import ipm_big

    devices = jax.devices()[:4]
    check(len(devices) == 4, f"need 4 devices, have {len(jax.devices())}")
    B, S, D, seed = sizes.four_batch
    s, d, M = bench.make_batch(B, S, D, seed=seed)
    engine = auto_engine(S, D, accelerator=True)
    max_piv = default_max_pivots(S, D)
    mesh = make_mesh(n_batch=4, devices=devices)
    compile_s, wall_s, out4 = _wall(
        lambda: sharded_batched_tnet_exact_device(
            mesh, s, d, M, reg=REG, sinkhorn_iters=sizes.sinkhorn_iters,
            max_pivots=max_piv, engine=engine), sizes.reps)
    peaks = [_peak_bytes(dv) for dv in devices]
    _, wall1_s, out1 = _wall(
        lambda: batched_tnet_exact_device(
            s, d, M, reg=REG, sinkhorn_iters=sizes.sinkhorn_iters,
            max_pivots=max_piv, engine=engine), sizes.reps)
    c4 = certify_ot_basis_batch(np.asarray(out4[5]), s, d, M)
    c1 = certify_ot_basis_batch(np.asarray(out1[5]), s, d, M)
    check(all(c.ok for c in c4), "sharded bases failed certification")
    check(all(c.ok for c in c1), "one-card bases failed certification")
    same_basis = bool(np.array_equal(np.asarray(out4[5]),
                                     np.asarray(out1[5])))
    worst = max(rel(a.obj_val, b_.obj_val) for a, b_ in zip(c4, c1))
    check(same_basis or worst <= 1e-9,
          f"sharded vs one-card objectives differ by {worst:.2e}")
    if not rehearse:
        check(all(p and p > 0 for p in peaks),
              f"a card did no work: peak bytes {peaks}")
    line = dict(ot=f"{B}x{S}x{D}", engine=engine, mesh="4x1",
                compile_s=compile_s, sharded_wall_s=wall_s,
                one_card_wall_s=wall1_s, identical_bases=same_basis,
                max_rel_obj_diff=worst, peak_bytes_per_card=peaks)
    m, n = sizes.big
    A, b, c = _dense_lp(np.random.default_rng(7), m, n)
    lo, up = np.zeros(n), np.ones(n)
    ref = linprog(c, A_eq=A, b_eq=b, bounds=[(0, 1)] * n, method="highs")
    t0 = time.perf_counter()
    one = ipm_big(A, b, c, lo, up, tol=1e-8)
    one_s = time.perf_counter() - t0
    col_mesh = make_mesh(n_batch=1, n_model=4, devices=devices)
    t0 = time.perf_counter()
    sh = ipm_big(A, b, c, lo, up, tol=1e-8, mesh=col_mesh)
    sh_s = time.perf_counter() - t0
    for name, r in (("one-card", one), ("column-sharded", sh)):
        check(r.status == "OPTIMAL", f"ipm_big {name}: {r.status}")
        check(rel(r.obj_val, ref.fun) <= 1e-6,
              f"ipm_big {name}: {r.obj_val!r} vs HiGHS {ref.fun!r}")
    line.update(big=f"{m}x{n}", big_one_card_s=one_s, big_sharded_s=sh_s,
                big_sharded_vs_one_card=rel(sh.obj_val, one.obj_val))
    report("4-cards", **line)


PHASES = {
    "0": phase0_device, "1": phase1_native, "2": phase2_card_tests,
    "3": phase3_ot_fleet, "4": phase4_network_crossover,
    "5": phase5_general_lp, "6": phase6_ipm,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Run the main paths once on the card and check them.")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths on a four-card mesh")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on the CPU: a harness check, no "
                         "measurement")
    args = ap.parse_args(argv)
    sizes = REHEARSE if args.rehearse else FULL
    try:
        dev = phase0_device(sizes, args.rehearse)
        if args.four_cards:
            check(args.rehearse or dev["count"] >= 4,
                  f"--four-cards needs 4 cards, JAX sees {dev['count']}")
        else:
            phase1_native(sizes, args.rehearse)
            phase2_card_tests(sizes, args.rehearse)
        import jax

        from smart_crossover_tpu.config import use_compile_cache

        use_compile_cache()
        platform = jax.devices()[0].platform
        check(args.rehearse or platform == "gpu",
              f"this process sees platform {platform!r}, not the GPU")
        if args.four_cards:
            phase_four_cards(sizes, args.rehearse)
            count = 4
        else:
            for key in ("3", "4", "5", "6"):
                PHASES[key](sizes, args.rehearse)
            count = len(jax.devices())
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    dev0 = jax.devices()[0]
    print(f"card: {bench.card_name_and_power()}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev0.platform, "kind": dev0.device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
