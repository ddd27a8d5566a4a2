"""Multi-host execution test: 2 OS processes, jax.distributed, CPU/Gloo.

Exercises ``parallel.mesh.init_distributed`` and the cross-process sharded
pipeline for real (VERDICT round-1 item 6): each process owns 2 virtual
CPU devices, the global mesh spans 4 devices across both processes, and
the projector CG's psum rides the Gloo collectives across the process
boundary.  On a machine with several cards the same code path runs one
worker per card over NCCL.
"""
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.timeout(300)
def test_two_process_distributed_pipeline(tmp_path):
    port = _free_port()
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
        JAX_ENABLE_X64="1",
    )
    procs = []
    for pid in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "smart_crossover_tpu.parallel.multihost",
             "--process-id", str(pid), "--num-processes", "2",
             "--coordinator", f"localhost:{port}"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env, cwd=REPO))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0, (
            f"proc {pid} failed (rc={rc})\nstdout:\n{out}\nstderr:\n{err}")
        assert f"MULTIHOST_PASS proc={pid} devices=4" in out, out
        assert "projector OK" in out and "sinkhorn OK" in out
