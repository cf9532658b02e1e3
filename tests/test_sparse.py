"""Sparse (ELLPACK) aggregation: parity vs the dense paths.

The reference aggregates with scalar loops (NeuralFingerprint.h:58-82,
GCN_MW.h:209-221); the dense path is a masked [V, V] matmul and the
sparse path is the ELLPACK SpMM (ops/sparse.py).  All three must agree.
"""

import numpy as np
import jax
import jax.numpy as jnp

from graphflow_tpu.core import prep
from graphflow_tpu.models.gcn import GCN_MW, NeuralFingerprint
from graphflow_tpu.ops import sparse
from graphflow_tpu.utils.datasets import random_graph


def test_ell_spmm_matches_dense():
    rng = np.random.default_rng(0)
    g = random_graph(40, 0.15, seed=3)
    A = g.adj.astype(np.float32)
    h = rng.standard_normal((40, 8)).astype(np.float32)

    nbr, w = sparse.ell_from_adj(A)
    out = sparse.ell_spmm(jnp.asarray(nbr), jnp.asarray(w), jnp.asarray(h))
    np.testing.assert_allclose(np.asarray(out), A @ h, rtol=1e-5, atol=1e-6)


def test_ell_spmm_weighted_and_padded():
    rng = np.random.default_rng(1)
    g = random_graph(17, 0.3, seed=4)
    W = g.adj.astype(np.float32) * rng.random((17, 17)).astype(np.float32)
    W = np.triu(W) + np.triu(W, 1).T  # symmetric weighted adjacency
    h = rng.standard_normal((24, 8)).astype(np.float32)  # padded to 24
    h[17:] = 0.0

    Wp = np.zeros((24, 24), np.float32)
    Wp[:17, :17] = W
    nbr, w = sparse.ell_from_adj(W, pad_rows=24)
    out = sparse.ell_spmm(jnp.asarray(nbr), jnp.asarray(w), jnp.asarray(h))
    np.testing.assert_allclose(np.asarray(out), Wp @ h, rtol=1e-5, atol=1e-6)


def test_coo_spmm_matches_ell():
    rng = np.random.default_rng(2)
    g = random_graph(30, 0.2, seed=5)
    A = g.adj.astype(np.float32)
    h = rng.standard_normal((30, 6)).astype(np.float32)
    src, dst = np.nonzero(A)
    out_coo = sparse.coo_spmm(jnp.asarray(src), jnp.asarray(dst),
                              jnp.ones(len(src), jnp.float32),
                              jnp.asarray(h), 30)
    # COO scatters w_e h[src] into dst: out[dst] += h[src] == (A h)[dst]
    np.testing.assert_allclose(np.asarray(out_coo), A @ h,
                               rtol=1e-5, atol=1e-6)


def test_norm_adj_ell_matches_dense_norm_adj():
    g = random_graph(25, 0.25, seed=6)
    edges = [(int(u), int(v))
             for (u, v) in np.argwhere(np.triu(g.adj, 1) > 0)]
    nbr, w = sparse.norm_adj_ell(25, edges)
    h = np.eye(25, dtype=np.float32)
    out = sparse.ell_spmm(jnp.asarray(nbr), jnp.asarray(w), jnp.asarray(h))
    np.testing.assert_allclose(np.asarray(out),
                               g.norm_adj().astype(np.float32),
                               rtol=1e-5, atol=1e-6)


def test_gcn_mw_ell_matches_dense():
    """Same weights, same graph: the ELL model output == dense model output
    (GCN_MW.h:209-221 semantics either way)."""
    g = random_graph(20, 0.25, seed=7)
    dense = GCN_MW(nLevels=2, max_nVertices=32, nFeatures=4, nHiddens=6,
                   nDepth=0, seed=3, aggregation="dense")
    ell = GCN_MW(nLevels=2, max_nVertices=32, nFeatures=4, nHiddens=6,
                 nDepth=0, seed=3, aggregation="ell")
    np.testing.assert_allclose(dense.Predict(g), ell.Predict(g), rtol=1e-4)
    np.testing.assert_allclose(dense.Feature(g), ell.Feature(g),
                               rtol=1e-4, atol=1e-6)


def test_neural_fingerprint_ell_matches_dense():
    g = random_graph(20, 0.25, seed=8)
    dense = NeuralFingerprint(nLevels=2, max_nVertices=32, nFeatures=4,
                              nHiddens=6, seed=3, aggregation="dense")
    ell = NeuralFingerprint(nLevels=2, max_nVertices=32, nFeatures=4,
                            nHiddens=6, seed=3, aggregation="ell")
    np.testing.assert_allclose(dense.Predict(g), ell.Predict(g), rtol=1e-4)
    np.testing.assert_allclose(dense.Feature(g), ell.Feature(g),
                               rtol=1e-4, atol=1e-6)


def test_gcn_mw_ell_trains():
    """The sparse path is differentiable end to end."""
    g = random_graph(20, 0.25, seed=9)
    model = GCN_MW(nLevels=1, max_nVertices=32, nFeatures=4, nHiddens=6,
                   nDepth=0, seed=0, aggregation="ell")
    l0, _ = model.BatchLearn([g], [5.0], 0.05)
    for _ in range(300):
        _, la = model.BatchLearn([g], [5.0], 0.05)
    assert la < 0.01 * l0


def test_sparse_prepare_edge_list_form():
    """The (n, edges, features) form never builds a dense adjacency."""
    n = 100
    rng = np.random.default_rng(10)
    edges = [(int(a), int(b)) for a, b in
             rng.integers(0, n, size=(300, 2)) if a != b]
    feats = np.eye(4)[rng.integers(0, 4, size=n)]
    pg = prep.prepare_graph_sparse((n, edges, feats), max_nVertices=128)
    assert pg.ell_nbr.shape[0] == 128
    assert pg.adj is None and pg.norm_adj is None
    assert sparse.edges_count(pg.ell_nbr_a) > 0


def test_ell_batch_heterogeneous_degrees():
    """Batching graphs with different max degrees through the ELL path:
    stack_graphs pads every ELLPACK structure to the batch max degree
    (sentinel rows / zero weights), so BatchLearn works on mixed
    molecules exactly like the dense path."""
    from graphflow_tpu.models.gcn import GCN_MW
    from tests.molecules import all_molecules

    graphs, targets = all_molecules()
    dense = GCN_MW(nLevels=2, max_nVertices=8, nFeatures=4, nHiddens=6,
                   nDepth=0, seed=3, aggregation="dense")
    ell = GCN_MW(nLevels=2, max_nVertices=8, nFeatures=4, nHiddens=6,
                 nDepth=0, seed=3, aggregation="ell")
    # CH4 (deg 4) and H2O (deg 2) force different per-graph ELL widths.
    l_dense = dense.getLoss(graphs, targets)
    l_ell = ell.getLoss(graphs, targets)
    np.testing.assert_allclose(l_ell, l_dense, rtol=1e-4)
    l1 = ell.BatchLearn(graphs, targets, 0.02)
    assert np.all(np.isfinite(np.asarray(l1)))
