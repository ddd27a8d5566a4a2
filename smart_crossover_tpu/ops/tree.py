"""Bipartite spanning-tree flow solve and push-to-feasibility.

Replaces the reference's sparse-LU tree solve (reference tree_BI.py:74-76)
with a parallel leaf-elimination sweep, and reimplements the sequential
"irrigation" push loop (tree_BI.py:85-110) as a `lax.while_loop` over dense
2x2 cycle updates.  Both are jittable and vmap over instance batches.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def bipartite_tree_solve(mask, s, d, max_rounds: int | None = None):
    """Solve the tree flow system on a bipartite spanning tree.

    Finds X supported on ``mask`` with row sums ``s`` and column sums ``d``
    (conservation at every node; the last equation is redundant because
    ``sum(s) == sum(d)``).  Flows may be negative — the tree solution of an
    infeasible-for-bounds basis, exactly what ``push_to_bfs`` repairs.

    A spanning tree always has a leaf; each round eliminates all supplier
    leaves then all demander leaves, assigning each eliminated leaf's unique
    remaining edge its residual balance.

    Args:
        mask: (S, D) boolean spanning-tree mask (S + D - 1 edges).
        s: (S,) supplies, d: (D,) demands.

    Returns:
        (S, D) tree flow matrix X.
    """
    S, D = mask.shape
    if max_rounds is None:
        max_rounds = S + D + 2
    dtype = jnp.result_type(s, d, jnp.float32)
    # each leaf round's scatter is an elementwise one-hot product and the
    # residual reduction a one-hot matmul, not scatters / segment_sum
    # (the idiom of ops/transport_simplex_parent.py)
    hi = jax.lax.Precision.HIGHEST

    def body(state):
        active, rs, rd, X, it = state

        # Supplier leaves: rows with exactly one active edge.  The leaf's
        # single active column one-hot is just its active row.
        deg_s = jnp.sum(active, axis=1)
        leaf_s = deg_s == 1
        oh_j = (active & leaf_s[:, None]).astype(dtype)   # (S, D)
        flow_s = jnp.where(leaf_s, rs, 0.0)
        X = X + flow_s[:, None] * oh_j
        rd = rd - jax.lax.dot_general(flow_s, oh_j, (((0,), (0,)), ((), ())),
                                      preferred_element_type=dtype,
                                      precision=hi)
        rs = rs - flow_s
        active = active & ~leaf_s[:, None]

        # Demander leaves.
        deg_d = jnp.sum(active, axis=0)
        leaf_d = deg_d == 1
        oh_i = (active & leaf_d[None, :]).astype(dtype)   # (S, D)
        flow_d = jnp.where(leaf_d, rd, 0.0)
        X = X + flow_d[None, :] * oh_i
        rs = rs - jax.lax.dot_general(oh_i, flow_d, (((1,), (0,)), ((), ())),
                                      preferred_element_type=dtype,
                                      precision=hi)
        rd = rd - flow_d
        active = active & ~leaf_d[None, :]

        return active, rs, rd, X, it + 1

    def cond(state):
        active, _, _, _, it = state
        return jnp.any(active) & (it < max_rounds)

    X0 = jnp.zeros((S, D), dtype=dtype)
    state = (mask, jnp.asarray(s, dtype), jnp.asarray(d, dtype), X0,
             jnp.asarray(0))
    _, _, _, X, _ = jax.lax.while_loop(cond, body, state)
    return X


def push_to_bfs(X, tol: float = 0.0, max_iter: int = 100_000):
    """Push a (possibly infeasible) tree flow to a feasible basic solution.

    Repeats the reference's "irrigation" 2x2 pivot
    (reference tree_BI.py:85-110): pick the most negative entry X[I1, J1],
    take J2 = argmax of row I1 and I2 = argmax of column J1, and shift
    ``theta = min(-X[I1,J1], X[I1,J2], X[I2,J1])`` around the 4-cycle
    (I1,J1)-(I1,J2)-(I2,J2)-(I2,J1).  Each step strictly reduces total
    negativity; row/column sums are invariant.

    Args:
        X: (S, D) signed tree flow (row sums = supplies, col sums = demands).

    Returns:
        (X_feasible, push_iters): the repaired flow and the iteration count.
    """
    S, D = X.shape

    def body(state):
        X, it = state
        flat_min = jnp.argmin(X.reshape(-1))
        I1, J1 = flat_min // D, flat_min % D
        J2 = jnp.argmax(X[I1, :])
        I2 = jnp.argmax(X[:, J1])
        theta = jnp.minimum(jnp.minimum(-X[I1, J1], X[I1, J2]), X[I2, J1])
        X = X.at[I1, J1].add(theta)
        X = X.at[I2, J1].add(-theta)
        X = X.at[I1, J2].add(-theta)
        X = X.at[I2, J2].add(theta)
        return X, it + 1

    def cond(state):
        X, it = state
        return (jnp.min(X) < -tol) & (it < max_iter)

    X, iters = jax.lax.while_loop(cond, body, (jnp.asarray(X), jnp.asarray(0)))
    return X, iters
