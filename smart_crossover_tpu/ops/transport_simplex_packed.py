"""Bit-packed ancestor-matrix batched transportation simplex on device.

Fourth-generation device simplex.  Same algorithm as
ops/transport_simplex_anc.py — the root-path indicator matrix maintained
incrementally across pivots — with two structural changes that cut the
per-pivot HBM traffic ~6x:

* N is stored BIT-PACKED: (V, V/32) uint32 words instead of (V, V) bytes.
  The XOR/OR row algebra is word-parallel.
* the LCA depth needs NO masked max-reduce: two root-path sets intersect
  in exactly the ancestor chain of their LCA, so
      lca_dep(u) = popcount(path(u) AND path(e_same)) - 1
  — one `lax.population_count` pass over the packed words.  The LCA node
  itself comes from the depth-ordered path list of e_same (an O(V)
  scatter), and is OR-ed back in as a single-bit one-hot per row.

Everything else (pricing, ratio test, O(V) path scatter, potential
shifts, exact tree-cost re-keying, refresh) matches the anc engine, which
remains the readable correctness oracle alongside
ops/transport_simplex{,_parent}.py.

Replaces the capability the reference buys from vendor network simplex
(reference net_manager.py:211-222) for the OT/bipartite case.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from smart_crossover_tpu.ops.transport_simplex_anc import (
    _num_levels,
    _tree_cells,
    build_ancestor_matrix,
)
from smart_crossover_tpu.ops.transport_simplex_parent import (
    _chain,
    build_parent_from_mask,
)

_HI = jax.lax.Precision.HIGHEST

_IOTA32 = None


def _iota32():
    return jnp.arange(32, dtype=jnp.uint32)


def pack_bool_rows(Nb, W: int):
    """(R, V) bool -> (R, W) uint32, bit j of word w = column 32w+j."""
    R, V = Nb.shape
    pad = W * 32 - V
    if pad:
        Nb = jnp.pad(Nb, ((0, 0), (0, pad)))
    bits = Nb.reshape(R, W, 32).astype(jnp.uint32)
    return jnp.sum(bits << _iota32()[None, None, :], axis=2,
                   dtype=jnp.uint32)


def unpack_row(p, V: int):
    """(W,) uint32 -> (V,) bool."""
    bits = ((p[:, None] >> _iota32()[None, :]) & 1) > 0
    return bits.reshape(-1)[:V]


@partial(jax.jit, static_argnames=("max_pivots", "refresh", "blocks"))
def transport_simplex_packed(X, Bm, M, s, d,
                             tol: float = 1e-7,
                             max_pivots: int = 5000,
                             refresh: int = 128,
                             blocks: int = 16):
    """Pivot a basic feasible transport plan to optimality (packed N).

    Same contract as ops.transport_simplex.transport_simplex:
        X: (S, D) basic feasible plan; Bm: spanning-tree basis mask;
        M: costs.  Returns (X_opt, Bm_opt, pivots, optimal_flag).

    ``blocks > 0`` enables multiple (block) pricing: a full O(S*D)
    pricing pass returns one candidate cell per block; between full
    passes, pivots price only the O(blocks) candidates against the
    CURRENT potentials — classic partial pricing, amortising the dense
    pass over several pivots.  Optimality is still certified by a full
    pass.  ``blocks=0`` restores per-pivot Dantzig.
    """
    S, D = M.shape
    V = S + D
    W = (V + 31) // 32
    K = _num_levels(V)
    dtype = M.dtype
    M = jnp.asarray(M, dtype)
    vids = jnp.arange(V, dtype=jnp.int32)
    iota_w = jnp.arange(W, dtype=jnp.int32)
    is_row_node = vids < S
    iota_s = jnp.arange(S, dtype=jnp.int32)
    iota_d = jnp.arange(D, dtype=jnp.int32)

    parent0 = build_parent_from_mask(Bm)
    N0 = build_ancestor_matrix(parent0, dtype)
    P0 = pack_bool_rows(N0, W)
    dep0 = jnp.sum(N0, axis=1, dtype=jnp.int32) - 1
    ci0, cj0, notroot0 = _tree_cells(parent0, S, D)
    # tree-cell values by flat gather (a V-element gather is ~1000x
    # cheaper than the (V,V) one-hot matmuls of _cell_values at 1024^2)
    cell_flat = jnp.where(notroot0, ci0 * D + cj0, 0)
    w0 = jnp.where(notroot0, M.reshape(-1)[cell_flat], 0.0)
    Xv0 = jnp.where(notroot0,
                    jnp.asarray(X, dtype).reshape(-1)[cell_flat], 0.0)
    Bm0 = jnp.asarray(Bm, bool)

    SD = S * D
    KB = max(int(blocks), 0)
    if KB:
        L = -(-SD // KB)            # block length (ceil)
        pad = KB * L - SD
        offs = (jnp.arange(KB, dtype=jnp.int32) * L)
    M_flat = M.reshape(-1)

    def _price_full(Bmk, u, v):
        """One dense pass -> (entering flat id, its rc, optimal?, cands)."""
        delta = jnp.where(Bmk, jnp.asarray(0.0, dtype),
                          M - u[:, None] - v[None, :])
        if not KB:
            flat = jnp.argmin(delta.reshape(-1)).astype(jnp.int32)
            dmin = jnp.min(delta)
            return flat, dmin, dmin >= -tol, None
        df = delta.reshape(-1)
        if pad:
            df = jnp.concatenate([df, jnp.zeros(pad, dtype)])
        db = df.reshape(KB, L)
        vals = jnp.min(db, axis=1)
        idxs = jnp.argmin(db, axis=1).astype(jnp.int32) + offs
        dmin = jnp.min(vals)
        kb = jnp.argmin(vals)
        cand = jnp.where(vals < -tol, idxs, SD)
        return idxs[kb], dmin, dmin >= -tol, cand

    def pivot_body(state):
        P, dep, parent, pot, w, Xv, Bmk, cand, dref, degen, it, _ = state
        u, v = pot[:S], pot[S:]

        if KB:
            # multiple pricing: candidates against CURRENT potentials.
            # Two safeguards against candidate-driven cycling (observed:
            # 20k pivots without convergence at 512^2): (1) long
            # DEGENERATE runs force full Dantzig passes; (2) a candidate
            # must beat a FRACTION of the last full-pass minimum — in f32
            # the incremental potentials carry ~1e-6 noise, and cells
            # with noise-level reduced costs otherwise re-enter forever.
            ci_c = cand // D
            cj_c = cand % D
            safe = jnp.minimum(cand, SD - 1)
            rc_c = (M_flat[safe] - u[jnp.minimum(ci_c, S - 1)]
                    - v[jnp.minimum(cj_c, D - 1)])
            basic_c = Bmk.reshape(-1)[safe]
            thresh = jnp.minimum(-tol, 0.25 * dref)
            valid = ((cand < SD) & ~basic_c & (rc_c < thresh)
                     & (degen < 24))

            def use_cand(_):
                k = jnp.argmin(jnp.where(valid, rc_c, 0.0))
                return cand[k], rc_c[k], jnp.asarray(False), cand, dref

            def full(_):
                fl, dm, dn, cd = _price_full(Bmk, u, v)
                return fl, dm, dn, cd, dm

            flat, dmin, done, cand, dref = jax.lax.cond(
                jnp.any(valid), use_cand, full, None)
        else:
            flat, dmin, done, _ = _price_full(Bmk, u, v)
        ei = (flat // D).astype(jnp.int32)
        ej = (flat % D).astype(jnp.int32)
        x_end = ei
        y_end = S + ej

        p_x = jax.lax.dynamic_slice_in_dim(P, x_end, 1, axis=0)[0]
        p_y = jax.lax.dynamic_slice_in_dim(P, y_end, 1, axis=0)[0]
        anc_x = unpack_row(p_x, V)
        anc_y = unpack_row(p_y, V)
        oncycle = anc_x ^ anc_y          # cycle EDGES, keyed by child node

        # bipartite alternation: x_end is a row node, so a cycle cell
        # changes by -theta iff (on x's branch and keyed by a row node)
        # or (on y's branch and keyed by a column node)
        sign = jnp.where(anc_x,
                         jnp.where(is_row_node, -1.0, 1.0),
                         jnp.where(is_row_node, 1.0, -1.0)).astype(dtype)
        sign = jnp.where(oncycle, sign, 0.0)

        dec = oncycle & (sign < 0)
        ratios = jnp.where(dec, Xv, jnp.asarray(jnp.inf, dtype))
        theta = jnp.min(ratios)
        cl = jnp.argmin(jnp.where(
            ratios <= theta + jnp.asarray(1e-12, dtype), vids, V
        ).astype(jnp.int32)).astype(jnp.int32)

        # re-hung component C = old subtree of cl: bit cl of every row
        cw = cl >> 5
        cb = (cl & 31).astype(jnp.uint32)
        col = jax.lax.dynamic_slice_in_dim(P, cw, 1, axis=1)[:, 0]
        C = ((col >> cb) & 1) > 0
        on_x_side = anc_x[cl]
        e_same = jnp.where(on_x_side, x_end, y_end)
        e_other = jnp.where(on_x_side, y_end, x_end)
        p_es = jnp.where(on_x_side, p_x, p_y)
        p_eo = jnp.where(on_x_side, p_y, p_x)
        n_es = jnp.where(on_x_side, anc_x, anc_y)

        # --- packed N update ----------------------------------------------
        # lca_dep(u) = |path(u) ∩ path(e_same)| - 1 (nested root paths)
        lca_dep = jnp.sum(jax.lax.population_count(P & p_es[None, :]),
                          axis=1).astype(jnp.int32) - 1
        # depth-ordered node list of e_same's path -> per-row LCA node
        L = jnp.zeros(V + 1, jnp.int32).at[
            jnp.where(n_es, dep, V)].set(vids, mode="drop")
        lca_node = L[jnp.clip(lca_dep, 0, V - 1)]
        wi = lca_node >> 5
        bmask = (jnp.uint32(1) << (lca_node & 31).astype(jnp.uint32))
        lca_oh = jnp.where(iota_w[None, :] == wi[:, None],
                           bmask[:, None], jnp.uint32(0))
        P_new = (P ^ p_es[None, :]) | lca_oh | p_eo[None, :]
        keep = (done | ~C)[:, None]
        P = jnp.where(keep, P, P_new)
        dep_next = jnp.sum(jax.lax.population_count(P),
                           axis=1).astype(jnp.int32) - 1

        # --- potentials: the entering arc must price to zero across the
        # C boundary; within C relative potentials are unchanged ----------
        row_shift = jnp.where(on_x_side, dmin, -dmin).astype(dtype)
        pot_new = pot + jnp.where(
            C, jnp.where(is_row_node, row_shift, -row_shift), 0.0)
        pot = jnp.where(done, pot, pot_new)

        # --- reversed path segment e_same..cl: every edge re-keys
        # child -> old parent; cl's old slot is the leaving arc and is
        # overwritten by its on-path child's value ------------------------
        seg = n_es & (dep >= dep[cl])            # path nodes e_same..cl
        src = seg & (vids != cl)                 # edges that re-key
        Xv_upd = Xv + sign * theta
        m_enter = (jnp.sum(jnp.where(vids == x_end, pot_new, 0.0))
                   + jnp.sum(jnp.where(vids == y_end, pot_new, 0.0)))

        # O(V) path scatter (targets distinct along a root path)
        tgt = jnp.where(src, parent, V)
        vals = jnp.stack([jnp.where(src, Xv_upd, 0.0),
                          jnp.where(src, w, 0.0),
                          src.astype(dtype) * vids.astype(dtype),
                          src.astype(dtype)], axis=1)
        moved = jnp.zeros((V + 1, 4), dtype).at[tgt].add(
            vals, mode="drop")[:V]
        hit = moved[:, 3] > 0.5

        Xv_new = jnp.where(hit, moved[:, 0], Xv_upd)
        Xv_new = jnp.where(vids == e_same, theta, Xv_new)
        w_new = jnp.where(hit, moved[:, 1], w)
        w_new = jnp.where(vids == e_same, m_enter, w_new)

        child_on_path = moved[:, 2].astype(jnp.int32)
        parent_new = jnp.where(seg & hit, child_on_path, parent)
        parent_new = jnp.where(vids == e_same, e_other, parent_new)

        # --- dense basis mask (pricing mask) ------------------------------
        p_cl = jnp.sum(jnp.where(vids == cl, parent, 0))
        li = jnp.where(cl < S, cl, p_cl)
        lj = jnp.where(cl < S, p_cl - S, cl - S)
        mask_e = (iota_s[:, None] == ei) & (iota_d[None, :] == ej)
        mask_l = (iota_s[:, None] == li) & (iota_d[None, :] == lj)
        Bm_new = (Bmk | mask_e) & ~mask_l

        parent = jnp.where(done, parent, parent_new)
        Xv = jnp.where(done, Xv, Xv_new)
        w = jnp.where(done, w, w_new)
        Bmk = jnp.where(done, Bmk, Bm_new)
        degen = jnp.where(done, degen,
                          jnp.where(theta <= jnp.asarray(1e-12, dtype),
                                    degen + 1, 0))
        return P, dep_next, parent, pot, w, Xv, Bmk, cand, dref, degen, \
            it + (~done).astype(jnp.int32), done

    def outer_body(state):
        P, dep, parent, pot, w, Xv, Bmk, cand, dref, degen, it, _ = state
        # exact potential refresh from the (exactly re-keyed) tree costs
        _, _, pot = _chain(parent, w, K, dtype)
        u, v = pot[:S], pot[S:]
        delta = jnp.where(Bmk, jnp.asarray(0.0, dtype),
                          M - u[:, None] - v[None, :])
        done = jnp.min(delta) >= -tol

        def run_chunk(st):
            return jax.lax.while_loop(
                lambda s_: (~s_[-1]) & (s_[-2] < it + refresh)
                           & (s_[-2] < max_pivots),
                pivot_body, st)

        state2 = (P, dep, parent, pot, w, Xv, Bmk, cand, dref, degen,
                  it, done)
        P, dep, parent, pot, w, Xv, Bmk, cand, dref, degen, it2, _ = \
            run_chunk(state2)
        # chunk_done reflects drifted pricing; the NEXT outer round's
        # refreshed check decides actual optimality; refreshed potentials
        # invalidate stale candidates
        cand = jnp.full_like(cand, S * D)
        return P, dep, parent, pot, w, Xv, Bmk, cand, dref, degen, it2, \
            done

    def outer_cond(state):
        *_, it, done = state
        return (~done) & (it < max_pivots)

    cand0 = jnp.full(max(KB, 1), SD, dtype=jnp.int32)
    state = (P0, dep0, parent0, jnp.zeros(V, dtype), w0, Xv0, Bm0,
             cand0, jnp.asarray(0.0, dtype), jnp.asarray(0, jnp.int32),
             jnp.asarray(0, jnp.int32), jnp.asarray(False))
    P, dep, parent, pot, w, Xv, Bmk, cand, dref, degen, pivots, done = \
        jax.lax.while_loop(outer_cond, outer_body, state)

    # reconstruct the dense plan from (parent, Xv) ONCE — a V-element 2-D
    # scatter; the basis mask is the carried pricing mask Bmk
    ci, cj, notroot = _tree_cells(parent, S, D)
    X_out = jnp.zeros((S, D), dtype).at[
        jnp.where(notroot, ci, S), jnp.where(notroot, cj, D)].add(
        jnp.where(notroot, Xv, 0.0), mode="drop")
    _, _, pot = _chain(parent, w, K, dtype)
    u, v = pot[:S], pot[S:]
    delta = jnp.where(Bmk, 0.0, M - u[:, None] - v[None, :])
    optimal = jnp.min(delta) >= -tol
    return jnp.maximum(X_out, 0.0), Bmk, pivots, optimal


@partial(jax.jit, static_argnames=("max_pivots", "refresh"))
def batched_transport_simplex_packed(X, Bm, M, s, d, tol: float = 1e-7,
                                     max_pivots: int = 5000,
                                     refresh: int = 128):
    """vmapped packed transport simplex over an instance batch."""
    return jax.vmap(
        lambda X_, B_, M_, s_, d_: transport_simplex_packed(
            X_, B_, M_, s_, d_, tol, max_pivots, refresh)
    )(X, Bm, M, s, d)
