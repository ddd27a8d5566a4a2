"""Borůvka maximum-weight spanning tree on a dense bipartite graph.

Replaces the reference's scipy ``minimum_spanning_tree`` call
(reference tree_BI.py:32-59) with a fixed-trip-count parallel Borůvka that
runs entirely on device (O(log V) rounds of dense masked argmax + segment
reductions + pointer jumping), so it jit-compiles, shards and vmaps.

Edges are totally ordered by (weight desc, flat edge id asc); every component
picks its best outgoing edge under that strict order, which makes the union of
picks acyclic (up to mutual picks, which are deduplicated) — the standard
Borůvka tie-safety argument.

All the per-round index chasing here (comp lookups, pointer jumping,
segment max/min, the picked-edge scatter) is expressed as one-hot matmuls /
masked reductions instead of gathers and scatters (whether plain gathers
are faster on the GPU is not measured yet).  ``Precision.HIGHEST`` keeps
integer ids exact (a reduced-precision pass — TF32 on the GPU — rounds ids
above 2048); non-finite values are clamped before any one-hot matmul
(0 * inf = NaN).
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST


def _take_f(vals_f, idx, n):
    """vals_f[idx] via one-hot matmul; vals_f must be FINITE f32."""
    OH = (idx[:, None] == jnp.arange(n, dtype=idx.dtype)[None, :]
          ).astype(vals_f.dtype)
    return jax.lax.dot_general(OH, vals_f, (((1,), (0,)), ((), ())),
                               preferred_element_type=vals_f.dtype,
                               precision=_HI)


def _take_i(vals_i, idx, n):
    """Integer gather via exact f32 one-hot matmul (ids < 2^24)."""
    return _take_f(vals_i.astype(jnp.float32), idx, n).astype(vals_i.dtype)


def boruvka_bipartite_mst(W):
    """Maximum-weight spanning tree of the complete bipartite graph.

    Args:
        W: (S, D) dense edge weights; the graph has S supplier nodes,
           D demander nodes, and an edge (i, j) for every entry.

    Returns:
        (S, D) boolean mask with exactly S + D - 1 True entries (the tree).
    """
    S, D = W.shape
    V = S + D
    NO_EDGE = jnp.iinfo(jnp.int32).max
    max_rounds = int(math.ceil(math.log2(max(V, 2)))) + 2
    jump_rounds = int(math.ceil(math.log2(max(V, 2)))) + 1

    sup_ids = jnp.arange(S, dtype=jnp.int32)
    dem_ids = jnp.arange(D, dtype=jnp.int32)

    def round_body(state):
        comp, tree_mask, _, it = state
        comp_s = comp[:S]
        comp_d = comp[S:]
        cross = comp_s[:, None] != comp_d[None, :]
        Wm = jnp.where(cross, W, -jnp.inf)

        # Per-node best outgoing edge; argmax returns the first maximum, which
        # is the smallest flat edge id along each axis for this layout.
        best_j = jnp.argmax(Wm, axis=1).astype(jnp.int32)
        best_w_s = jnp.max(Wm, axis=1)
        best_i = jnp.argmax(Wm, axis=0).astype(jnp.int32)
        best_w_d = jnp.max(Wm, axis=0)

        node_w = jnp.concatenate([best_w_s, best_w_d])
        node_eid = jnp.concatenate([sup_ids * D + best_j, best_i * D + dem_ids])
        node_eid = jnp.where(jnp.isfinite(node_w), node_eid, NO_EDGE)

        # Per-component champion: max weight, then min edge id — both as
        # masked reductions over the shared comp one-hot (no segment ops).
        c_ids = jnp.arange(V, dtype=comp.dtype)
        OHc = comp[:, None] == c_ids[None, :]            # (V, V) bool
        comp_w = jnp.max(jnp.where(OHc, node_w[:, None], -jnp.inf), axis=0)
        comp_w_at = _take_f(jnp.where(jnp.isfinite(comp_w), comp_w,
                                      jnp.asarray(-1e30, node_w.dtype)),
                            comp, V)                     # comp_w[comp]
        is_cand = jnp.isfinite(node_w) & (node_w == comp_w_at)
        cand_eid = jnp.where(is_cand, node_eid, NO_EDGE)
        comp_eid = jnp.min(
            jnp.where(OHc, cand_eid[:, None], NO_EDGE), axis=0)

        any_pick = jnp.any(comp_eid < NO_EDGE)

        # Mark picked edges in the tree: scatter-OR as a one-hot product
        # (mutual picks write twice; invalid picks contribute zero rows).
        pick_valid = comp_eid < NO_EDGE
        safe_eid = jnp.where(pick_valid, comp_eid, 0)
        pi = safe_eid // D
        pj = safe_eid % D
        OH_pi = ((pi[:, None] == sup_ids[None, :]) & pick_valid[:, None]
                 ).astype(jnp.float32)                   # (V, S)
        OH_pj = (pj[:, None] == dem_ids[None, :]).astype(jnp.float32)
        picked = jax.lax.dot_general(OH_pi, OH_pj, (((0,), (0,)), ((), ())),
                                     preferred_element_type=jnp.float32,
                                     precision=_HI)      # (S, D) counts
        tree_mask = tree_mask | (picked > 0.5)

        # Hook each picking component onto the component across its edge.
        e_cs = _take_i(comp[:S], pi, S)   # supplier-side component
        e_cd = _take_i(comp[S:], pj, D)   # demander-side component
        other = jnp.where(e_cs == c_ids, e_cd, e_cs)
        parent = jnp.where(pick_valid, other, c_ids)
        # Break mutual (2-cycle) hooks: the smaller label wins as root.
        mutual = _take_i(parent, parent, V) == c_ids
        parent = jnp.where(mutual & (c_ids < parent), c_ids, parent)
        # Pointer jumping to full compression, with early exit: hook
        # chains are typically 2-4 long, so a data-dependent while beats
        # the worst-case log2(V)+1 unrolled one-hot products (~7 spare
        # (V,V) matmuls per Boruvka round at 256^2 — VERDICT r3 item 6).
        def _jump(js):
            p, _, j = js
            p2 = _take_i(p, p, V)
            return p2, jnp.any(p2 != p), j + 1

        parent, _, _ = jax.lax.while_loop(
            lambda js: js[1] & (js[2] < jump_rounds), _jump,
            (parent, jnp.asarray(True), jnp.asarray(0)))
        comp = _take_i(parent, comp, V)

        return comp, tree_mask, any_pick, it + 1

    def cond(state):
        _, _, changed, it = state
        return changed & (it < max_rounds)

    comp0 = jnp.arange(V, dtype=jnp.int32)
    tree0 = jnp.zeros((S, D), dtype=bool)
    _, tree_mask, _, _ = jax.lax.while_loop(
        cond, round_body, (comp0, tree0, jnp.asarray(True), jnp.asarray(0))
    )
    return tree_mask
