"""Device-mesh helpers.

The framework's two scaling axes (SURVEY.md §5: problem size and instance
batch) map onto a 2-D mesh:

* ``batch``  — data parallelism over OT/MCF instances (scenario batches);
* ``model`` — intra-instance parallelism: columns of the OT cost/plan
  matrices, LP column blocks, and the projector's CG reductions (psum).
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BATCH_AXIS = "batch"
MODEL_AXIS = "model"


def init_distributed(**kwargs) -> None:
    """Initialise multi-process JAX (jax.distributed.initialize); a no-op
    when it cannot (single process / already initialised).  After this,
    `jax.devices()` spans all processes and the meshes below shard across
    them."""
    import jax

    try:
        jax.distributed.initialize(**kwargs)
    except (RuntimeError, ValueError):
        pass  # single host / already initialised


def make_mesh(n_batch: int | None = None, n_model: int = 1,
              devices=None) -> Mesh:
    """Build a (batch, model) mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n_batch is None:
        n_batch = n // n_model
    if n_batch * n_model != n:
        raise ValueError(
            f"mesh {n_batch}x{n_model} does not match {n} devices")
    arr = np.asarray(devices).reshape(n_batch, n_model)
    return Mesh(arr, (BATCH_AXIS, MODEL_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(BATCH_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
