import numpy as np
import scipy.sparse as sp

from smart_crossover_tpu.ops import (
    bipartite_tree_solve,
    boruvka_bipartite_mst,
    mcf_flow_indicators,
    ot_flow_indicators,
    push_to_bfs,
    sort_flows,
)
from tests.conftest import random_ot


def reference_mcf_indicators(x, A, u):
    """Oracle: the reference's scipy-sparse flow-indicator computation
    (net_manager.py:156-184), reimplemented verbatim with scipy."""
    m, n = A.shape
    mask_large = x > u / 2
    x_hat = x * (~mask_large) + u * mask_large - x * mask_large
    x_hat[(x < 0) | (x > u)] = 0
    A_bar = A.multiply(~mask_large) - A.multiply(mask_large)
    A_plus = A_bar.maximum(sp.csc_matrix((m, n)))
    A_minus = (-A_bar).maximum(sp.csc_matrix((m, n)))
    f = np.maximum(A_plus @ x_hat, A_minus @ x_hat)
    f_inv = np.divide(1, f, out=np.zeros_like(f), where=f != 0)
    row, col, a = sp.find(A_bar)
    val = f_inv[row] * x_hat[col]
    r = sp.csc_matrix((val * a, (row, col)), shape=(m, n))
    r1 = sp.csr_matrix.max(r.multiply(sp.csr_matrix.sign(r)), axis=0)
    return np.asarray(r1.todense()).reshape(n)


def test_mcf_flow_indicators_match_scipy_oracle(rng):
    ot = random_ot(rng, 5, 6)
    mcf = ot.to_MCF()
    # finite capacities to exercise the reversal branch
    u = rng.uniform(0.5, 3.0, mcf.n)
    x = rng.uniform(-0.2, 3.5, mcf.n)  # includes out-of-bound flows
    ours = np.asarray(
        mcf_flow_indicators(x, mcf.tails, mcf.heads, u, mcf.m)
    )
    oracle = reference_mcf_indicators(x.copy(), mcf.A.tocsc(), u)
    np.testing.assert_allclose(ours, oracle, atol=1e-12)


def test_ot_indicators_and_sort(rng):
    ot = random_ot(rng, 4, 5)
    X = rng.uniform(0, 1, (4, 5))
    ind = np.asarray(ot_flow_indicators(X, ot.s, ot.d))
    oracle = np.maximum(X / ot.s[:, None], X / ot.d[None, :])
    np.testing.assert_allclose(ind, oracle)
    queue = np.asarray(sort_flows(ind))
    flat = ind.ravel()
    assert np.all(np.diff(flat[queue]) <= 1e-15)


def scipy_max_spanning_tree_weight(W):
    S, D = W.shape
    V = S + D
    row = np.repeat(np.arange(S), D)
    col = S + np.tile(np.arange(D), S)
    g = sp.coo_matrix((-W.ravel(), (row, col)), shape=(V, V))
    t = sp.csgraph.minimum_spanning_tree(g)
    return -t.sum()


def test_boruvka_mst_matches_scipy_weight(rng):
    for shape in [(5, 7), (8, 3), (12, 12)]:
        W = rng.uniform(0.1, 10.0, shape)
        mask = np.asarray(boruvka_bipartite_mst(W))
        assert mask.sum() == shape[0] + shape[1] - 1
        # the tree must actually be spanning (connected)
        S, D = shape
        ii, jj = np.where(mask)
        g = sp.coo_matrix((np.ones(ii.size), (ii, S + jj)), shape=(S + D, S + D))
        ncomp, _ = sp.csgraph.connected_components(g, directed=False)
        assert ncomp == 1
        np.testing.assert_allclose(W[mask].sum(),
                                   scipy_max_spanning_tree_weight(W), rtol=1e-12)


def test_boruvka_mst_with_ties():
    W = np.ones((6, 4))  # fully degenerate weights
    mask = np.asarray(boruvka_bipartite_mst(W))
    assert mask.sum() == 9
    ii, jj = np.where(mask)
    g = sp.coo_matrix((np.ones(ii.size), (ii, 6 + jj)), shape=(10, 10))
    ncomp, _ = sp.csgraph.connected_components(g, directed=False)
    assert ncomp == 1


def test_tree_solve_matches_spsolve(rng):
    ot = random_ot(rng, 6, 8)
    W = rng.uniform(0.1, 1.0, (6, 8))
    mask = np.asarray(boruvka_bipartite_mst(W))
    X = np.asarray(bipartite_tree_solve(mask, ot.s, ot.d))
    # conservation
    np.testing.assert_allclose(X.sum(axis=1), ot.s, atol=1e-9)
    np.testing.assert_allclose(X.sum(axis=0), ot.d, atol=1e-9)
    # support only on the tree
    assert np.all(X[~mask] == 0)
    # oracle: sparse solve of the (m-1)x(m-1) tree basis system as the
    # reference does (tree_BI.py:74-76)
    mcf = ot.to_MCF()
    tree_cols = np.flatnonzero(mask.ravel())
    B = mcf.A.tocsc()[:-1, :][:, tree_cols]
    sol = sp.linalg.spsolve(B.tocsc(), mcf.b[:-1])
    X_oracle = np.zeros(mcf.n)
    X_oracle[tree_cols] = sol
    np.testing.assert_allclose(X.ravel(), X_oracle, atol=1e-8)


def test_push_to_bfs_fixes_negatives(rng):
    ot = random_ot(rng, 6, 8)
    W = rng.uniform(0.1, 1.0, (6, 8))
    mask = np.asarray(boruvka_bipartite_mst(W))
    X = np.asarray(bipartite_tree_solve(mask, ot.s, ot.d))
    Xf, iters = push_to_bfs(X)
    Xf = np.asarray(Xf)
    assert np.min(Xf) >= 0
    np.testing.assert_allclose(Xf.sum(axis=1), ot.s, atol=1e-9)
    np.testing.assert_allclose(Xf.sum(axis=0), ot.d, atol=1e-9)
    if np.min(X) >= 0:
        assert int(iters) == 0


def test_push_to_bfs_known_negative():
    # hand-built infeasible tree flow on a 2x2 grid
    X = np.array([[3.0, -1.0], [0.0, 2.0]])
    Xf, iters = push_to_bfs(X)
    Xf = np.asarray(Xf)
    assert np.min(Xf) >= 0
    np.testing.assert_allclose(Xf.sum(axis=1), [2.0, 2.0])
    np.testing.assert_allclose(Xf.sum(axis=0), [3.0, 1.0])
    assert int(iters) >= 1


def test_one_hot_gather_helpers_match_numpy(rng):
    """_take_f/_take_i (the one-hot gather idiom used across mst.py,
    transport_simplex_parent.py and tnet_sharded.py) must be EXACT."""
    import numpy as np

    from smart_crossover_tpu.ops.mst import _take_f, _take_i

    for trial in range(5):
        n = int(rng.integers(3, 600))
        vals_f = rng.standard_normal(n)
        vals_i = rng.integers(0, 2**20, n).astype(np.int32)
        idx = rng.integers(0, n, n).astype(np.int32)
        np.testing.assert_array_equal(
            np.asarray(_take_f(vals_f, idx, n)), vals_f[idx])
        np.testing.assert_array_equal(
            np.asarray(_take_i(vals_i, idx, n)), vals_i[idx])
