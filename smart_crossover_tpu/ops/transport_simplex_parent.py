"""Parent-array batched transportation simplex on device.

Second-generation device simplex.  The first implementation
(ops/transport_simplex.py) pays O(S*D * tree-diameter) per pivot:
potentials and cycles are found by dense masked propagation over the
basis mask.  This one carries the basis
tree explicitly as a ``parent`` vector over the V = S + D nodes and runs
every per-pivot step as O(V log V) work via binary lifting.

Design detail: instead of vector gathers (``x[p]``), every per-pivot
recursion here is expressed as matmuls against one-hot matrices built
with broadcast comparisons:

* one chain pass builds the lifting tables, depths and dual potentials
  together — ONE (V,V) one-hot per doubling round, all three recursions
  gathered through a single stacked (4,V)x(V,V) product;
* root-path indicators for both entering-arc endpoints (the cycle test:
  a tree arc is on the x..y cycle iff its child is an ancestor of exactly
  one endpoint) come from a second pass over the SAME tables — one shared
  one-hot per round for both endpoints;
* tree-cell reads M[ci,cj], X[ci,cj] and the cycle's scatter-update of X
  go through per-arc cell one-hots E_row (V,S) / E_col (V,D) and two
  (V,S)x(S,D) matmuls — no gather/scatter ops anywhere in the pivot loop.

Replaces the capability the reference buys from vendor network simplex
(reference net_manager.py:211-222) for the OT/bipartite case; the mask
implementation stays as the correctness oracle (tests cross-check them).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _num_levels(V: int) -> int:
    K = 1
    while (1 << K) < V:
        K += 1
    return K


def build_parent_from_mask(Bm, max_rounds: int | None = None):
    """Root the basis-tree mask at node 0 (row 0) as a parent vector.

    Nodes 0..S-1 are rows (suppliers), S..S+D-1 are columns.  BFS-style
    masked propagation, O(diameter) rounds — run ONCE per solve, not per
    pivot.  Returns parent (V,) int32 with parent[root] == root.
    """
    S, D = Bm.shape
    V = S + D
    if max_rounds is None:
        max_rounds = V + 2

    def body(state):
        parent, arow, acol, it = state
        # unassigned columns adjacent (in the tree) to an assigned row:
        # in a tree there is exactly one such row per newly reached column.
        reach_c = Bm & arow[:, None] & ~acol[None, :]
        hit_c = jnp.any(reach_c, axis=0)
        pi_c = jnp.argmax(reach_c, axis=0).astype(jnp.int32)  # the one row
        parent = parent.at[S:].set(jnp.where(hit_c, pi_c, parent[S:]))
        acol = acol | hit_c
        # unassigned rows adjacent to an assigned column
        reach_r = Bm & acol[None, :] & ~arow[:, None]
        hit_r = jnp.any(reach_r, axis=1)
        pj_r = (jnp.argmax(reach_r, axis=1) + S).astype(jnp.int32)
        parent = parent.at[:S].set(jnp.where(hit_r, pj_r, parent[:S]))
        arow = arow | hit_r
        return parent, arow, acol, it + 1

    def cond(state):
        _, arow, acol, it = state
        return ~(jnp.all(arow) & jnp.all(acol)) & (it < max_rounds)

    parent0 = jnp.zeros(V, jnp.int32)
    arow0 = jnp.zeros(S, bool).at[0].set(True)
    acol0 = jnp.zeros(D, bool)
    parent, *_ = jax.lax.while_loop(
        cond, body, (parent0, arow0, acol0, jnp.asarray(0)))
    return parent


def _cell_onehots(parent, S, D, dtype):
    """Per-arc cell one-hots: E_r (V,S), E_c (V,D) with
    E_r[v,i] = 1{ci(v)=i}, E_c[v,j] = 1{cj(v)=j}; zero rows at the root."""
    V = S + D
    vids = jnp.arange(V, dtype=jnp.int32)
    is_row = vids < S
    ci = jnp.where(is_row, vids, parent)
    cj = jnp.where(is_row, parent - S, vids - S)
    notroot = parent != vids
    E_r = ((ci[:, None] == jnp.arange(S, dtype=jnp.int32)[None, :])
           & notroot[:, None]).astype(dtype)
    E_c = ((cj[:, None] == jnp.arange(D, dtype=jnp.int32)[None, :])
           & notroot[:, None]).astype(dtype)
    return E_r, E_c, ci, cj


def _chain(parent, w, K, dtype):
    """One pass of K doubling rounds: lifting tables (as f32 node ids),
    depths, and dual potentials — a single (V,V) one-hot per round and one
    stacked matmul gather for all recursions.

    Potentials satisfy pot[v] = w(v) - pot[parent(v)] (bipartite
    alternation); the (acc, sgn) pair composes the affine recursion under
    pointer doubling.
    """
    V = parent.shape[0]
    iota = jnp.arange(V, dtype=dtype)
    isroot = parent == jnp.arange(V)
    dep = (~isroot).astype(dtype)
    acc = jnp.where(isroot, jnp.asarray(0.0, dtype), w)
    sgn = jnp.where(isroot, 0.0, -1.0).astype(dtype)
    ptr = parent.astype(dtype)
    tabs = []
    for _ in range(K):
        tabs.append(ptr)
        OH = (ptr[:, None] == iota[None, :]).astype(dtype)       # (V, V)
        st = jnp.stack([dep, acc, sgn, ptr])                     # (4, V)
        g = jax.lax.dot_general(st, OH, (((1,), (1,)), ((), ())),
                                preferred_element_type=dtype,
                                precision=jax.lax.Precision.HIGHEST)    # st[:,ptr]
        dep = dep + g[0]
        acc = acc + sgn * g[1]
        sgn = sgn * g[2]
        ptr = g[3]
    return tabs, dep.astype(jnp.int32), acc


def _root_paths2(x_end, y_end, tabs, dtype):
    """Root-path indicator vectors for two endpoints: path[v] > 0 iff v is
    an ancestor of (or equal to) the endpoint.  One shared one-hot per
    lifting level for both endpoints."""
    V = tabs[0].shape[0]
    iota = jnp.arange(V, dtype=dtype)
    idx = jnp.arange(V, dtype=jnp.int32)
    px = (idx == x_end).astype(dtype)
    py = (idx == y_end).astype(dtype)
    paths = jnp.stack([px, py])                                  # (2, V)
    for tab in tabs:
        OH = (tab[:, None] == iota[None, :]).astype(dtype)       # (V, V)
        # reach_new[u] = sum_w reach[w] * 1{tab[w] == u}
        paths = paths + jax.lax.dot_general(
            paths, OH, (((1,), (0,)), ((), ())),
            preferred_element_type=dtype,
                                precision=jax.lax.Precision.HIGHEST)
    return paths[0] > 0, paths[1] > 0


@partial(jax.jit, static_argnames=("max_pivots",))
def transport_simplex_parent(X, Bm, M, s, d,
                             tol: float = 1e-7,
                             max_pivots: int = 5000):
    """Pivot a basic feasible transport plan to optimality (parent-array).

    Same contract as ops.transport_simplex.transport_simplex:

    Args:
        X: (S, D) basic feasible plan (row sums s, col sums d).
        Bm: (S, D) spanning-tree basis mask.
        M: (S, D) costs.

    Returns:
        (X_opt, Bm_opt, pivots, optimal_flag).
    """
    S, D = M.shape
    V = S + D
    K = _num_levels(V)
    vids = jnp.arange(V, dtype=jnp.int32)
    dtype = M.dtype
    iota_s = jnp.arange(S, dtype=jnp.int32)
    iota_d = jnp.arange(D, dtype=jnp.int32)

    parent0 = build_parent_from_mask(Bm)

    def body(state):
        X, Bm, parent, it, _ = state
        E_r, E_c, ci, cj = _cell_onehots(parent, S, D, dtype)
        # tree-cell reads via one-hot matmuls (no gathers):
        #   w[v] = M[ci(v), cj(v)],  Xv[v] = X[ci(v), cj(v)]
        TM = jax.lax.dot_general(E_r, M, (((1,), (0,)), ((), ())),
                                 preferred_element_type=dtype,
                                precision=jax.lax.Precision.HIGHEST)   # (V, D)
        TX = jax.lax.dot_general(E_r, X, (((1,), (0,)), ((), ())),
                                 preferred_element_type=dtype,
                                precision=jax.lax.Precision.HIGHEST)
        w = jnp.sum(TM * E_c, axis=1)
        Xv = jnp.sum(TX * E_c, axis=1)

        tabs, dep, pot = _chain(parent, w, K, dtype)
        u, v = pot[:S], pot[S:]

        # pricing (the one dense O(S*D) op)
        delta = M - u[:, None] - v[None, :]
        delta = jnp.where(Bm, jnp.asarray(0.0, dtype), delta)
        flat = jnp.argmin(delta.reshape(-1))
        dmin = delta.reshape(-1)[flat]
        done = dmin >= -tol
        ei = (flat // D).astype(jnp.int32)
        ej = (flat % D).astype(jnp.int32)
        x_end = ei                                  # row endpoint node
        y_end = (S + ej).astype(jnp.int32)          # col endpoint node

        # ancestor indicators for both endpoints (root-path membership)
        anc_x, anc_y = _root_paths2(x_end, y_end, tabs, dtype)
        root = parent == vids
        oncycle = (anc_x ^ anc_y) & ~root

        dx = dep[x_end]
        dy = dep[y_end]
        # bipartite alternation: the tree cell at child c changes by
        # -theta when the hop count from its endpoint is even
        par_x = (dx - dep) % 2 == 0
        par_y = (dy - dep) % 2 == 0
        sign = jnp.where(anc_x, jnp.where(par_x, -1.0, 1.0),
                         jnp.where(par_y, -1.0, 1.0)).astype(dtype)
        sign = jnp.where(oncycle, sign, 0.0)

        dec = oncycle & (sign < 0)
        ratios = jnp.where(dec, Xv, jnp.inf)
        theta = jnp.min(ratios)
        # leaving arc: min ratio, smallest node index tie-break
        cl = jnp.argmin(jnp.where(ratios <= theta + jnp.asarray(1e-12, dtype),
                                  vids, V).astype(jnp.int32)).astype(jnp.int32)
        li, lj = ci[cl], cj[cl]

        # X update: scatter over the cycle's tree cells as a one-hot
        # matmul  sum_v coeff[v] e_ci(v) e_cj(v)' = (E_r*coeff)' E_c
        coeff = sign * theta
        upd = jax.lax.dot_general(E_r * coeff[:, None], E_c,
                                  (((0,), (0,)), ((), ())),
                                  preferred_element_type=dtype,
                                precision=jax.lax.Precision.HIGHEST)  # (S, D)
        mask_e = (iota_s[:, None] == ei) & (iota_d[None, :] == ej)
        mask_l = (iota_s[:, None] == li) & (iota_d[None, :] == lj)
        X_new = X + upd + jnp.where(mask_e, theta, 0.0).astype(dtype)
        X_new = jnp.maximum(X_new, 0.0)
        X_new = jnp.where(mask_l, 0.0, X_new)
        Bm_new = (Bm | mask_e) & ~mask_l

        # tree update: reverse the path from the entering endpoint on the
        # leaving arc's side up to cl, then hang that endpoint off the
        # other endpoint through the entering arc.  The on-path child of v
        # is the unique path node u with parent(u) = v:
        #   child[v] = sum_u path[u] * u * 1{parent[u] = v}
        on_x_side = anc_x[cl]
        e_same = jnp.where(on_x_side, x_end, y_end)   # endpoint to re-root
        e_other = jnp.where(on_x_side, y_end, x_end)
        anc_e = jnp.where(on_x_side, anc_x, anc_y)
        OH0 = (parent.astype(dtype)[:, None]
               == jnp.arange(V, dtype=dtype)[None, :]).astype(dtype)
        child_f = jax.lax.dot_general(
            (anc_e.astype(dtype) * vids.astype(dtype))[None, :], OH0,
            (((1,), (0,)), ((), ())),
            preferred_element_type=dtype,
                                precision=jax.lax.Precision.HIGHEST)[0]
        child_on_path = child_f.astype(jnp.int32)
        seg = anc_e & (dep >= dep[cl])
        parent_new = jnp.where(seg, child_on_path, parent)
        parent_new = parent_new.at[e_same].set(e_other)

        X = jnp.where(done, X, X_new)
        Bm = jnp.where(done, Bm, Bm_new)
        parent = jnp.where(done, parent, parent_new)
        return X, Bm, parent, it + (~done).astype(jnp.int32), done

    def cond(state):
        _, _, _, it, done = state
        return (~done) & (it < max_pivots)

    X, Bm, parent, pivots, done = jax.lax.while_loop(
        cond, body, (jnp.asarray(X, dtype), jnp.asarray(Bm), parent0,
                     jnp.asarray(0), jnp.asarray(False)))
    E_r, E_c, _, _ = _cell_onehots(parent, S, D, dtype)
    TM = jax.lax.dot_general(E_r, M, (((1,), (0,)), ((), ())),
                             preferred_element_type=dtype,
                                precision=jax.lax.Precision.HIGHEST)
    w = jnp.sum(TM * E_c, axis=1)
    _, _, pot = _chain(parent, w, K, dtype)
    u, v = pot[:S], pot[S:]
    delta = jnp.where(Bm, 0.0, M - u[:, None] - v[None, :])
    optimal = jnp.min(delta) >= -tol
    return X, Bm, pivots, optimal


@partial(jax.jit, static_argnames=("max_pivots",))
def batched_transport_simplex_parent(X, Bm, M, s, d, tol: float = 1e-7,
                                     max_pivots: int = 5000):
    """vmapped parent-array transport simplex over an instance batch."""
    return jax.vmap(
        lambda X_, B_, M_, s_, d_: transport_simplex_parent(
            X_, B_, M_, s_, d_, tol, max_pivots)
    )(X, Bm, M, s, d)
