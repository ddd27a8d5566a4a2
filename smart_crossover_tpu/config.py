"""Precision and device policy.

The reference codebase (smart-crossover) runs everything in float64 on the
host and delegates exact pivoting to commercial solvers.  This framework
splits the numerics:

* approximate, massively-parallel work (Sinkhorn, PDHG, flow ranking, MST,
  tree push, the device pivot loop) runs in the *device* dtype — float32
  unless x64 is enabled;
* exactness-critical cleanup (optimality certificates, the host simplex
  and network-simplex cores) runs on the host in float64 (numpy / native
  C++), so a returned vertex is exact whatever the device precision.

Use :func:`device_float` wherever a JAX kernel needs a dtype and
:data:`HOST_FLOAT` for host-side exact arithmetic.
"""
from __future__ import annotations

import functools
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

HOST_FLOAT = np.float64
HOST_INT = np.int64

# the checkout root: <root>/smart_crossover_tpu/config.py
_ROOT = Path(__file__).resolve().parent.parent


def x64_enabled() -> bool:
    return bool(jax.config.read("jax_enable_x64"))


def device_float():
    """Float dtype for JAX device computation (f64 iff x64 is enabled)."""
    return jnp.float64 if x64_enabled() else jnp.float32


def device_int():
    return jnp.int64 if x64_enabled() else jnp.int32


def default_backend() -> str:
    return jax.default_backend()


def on_accelerator() -> bool:
    """Whether the default JAX device is an accelerator (not the CPU)."""
    return default_backend() != "cpu"


def full_precision_matmuls(fn):
    """Trace ``fn`` with every float32 matrix product at
    ``Precision.HIGHEST``.  At the default precision a float32 product may
    run in TF32 on the GPU (about three decimal digits); the first-order
    solvers' tolerances assume full float32 products."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)
    return wrapped


def use_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is where the cache goes and
    this leaves JAX's setting alone.  Otherwise the cache lives at the
    fixed path ``<checkout>/.jax_cache``: the path is part of the cache's
    key, so a directory that moved between runs would never hit."""
    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = str(_ROOT / ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    return cache_dir
