"""Host-side graph container (the L5 "graph data" layer).

The equivalent of the reference's ``GraphFlow/DenseGraph.h``: a plain
NumPy container holding adjacency, vertex features and the optional Coulomb /
distance matrices used by the physics model variants, plus the Kipf-Welling
normalized adjacency (reference ``DenseGraph.h:69-111``).

Everything here is host/NumPy: graphs are raw data.  Device arrays only appear
after preprocessing + padding (see ``graphflow_tpu.core.prep`` and
``graphflow_tpu.core.batching``).
"""

from __future__ import annotations

import numpy as np


class DenseGraph:
    """A dense graph: adjacency + per-vertex features (+ coulomb/distance).

    Mirrors reference ``DenseGraph.h:113-119`` members:
    ``nVertices, nFeatures, adj, feature, coulomb, distance``.
    """

    def __init__(self, nVertices: int, nFeatures: int):
        self.nVertices = int(nVertices)
        self.nFeatures = int(nFeatures)
        self.adj = np.zeros((nVertices, nVertices), dtype=np.int32)
        self.feature = np.zeros((nVertices, nFeatures), dtype=np.float64)
        self.coulomb = np.zeros((nVertices, nVertices), dtype=np.float64)
        self.distance = np.zeros((nVertices, nVertices), dtype=np.float64)

    # ------------------------------------------------------------------
    # Construction helpers
    # ------------------------------------------------------------------

    @classmethod
    def from_edges(cls, nVertices, nFeatures, edges, features=None) -> "DenseGraph":
        """Build an undirected graph from an edge list.

        ``edges`` is an iterable of (u, v) pairs; ``features`` an optional
        [nVertices, nFeatures] array.
        """
        g = cls(nVertices, nFeatures)
        for (u, v) in edges:
            g.add_edge(u, v)
        if features is not None:
            feats = np.asarray(features, dtype=np.float64)
            assert feats.shape == (nVertices, nFeatures)
            g.feature[:] = feats
        return g

    def add_edge(self, u: int, v: int) -> None:
        self.adj[u, v] = 1
        self.adj[v, u] = 1

    def permuted(self, perm) -> "DenseGraph":
        """Return a copy with vertices relabeled by ``perm`` (new = perm[old]).

        Used by the permutation-invariance property tests (the reference's
        ``tests/test_graph_permutation_invariant.cpp:51-83`` builds the
        permuted graph by hand).
        """
        perm = np.asarray(perm, dtype=np.int64)
        assert perm.shape == (self.nVertices,)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(self.nVertices)
        g = DenseGraph(self.nVertices, self.nFeatures)
        g.adj = self.adj[np.ix_(inv, inv)].copy()
        g.feature = self.feature[inv].copy()
        g.coulomb = self.coulomb[np.ix_(inv, inv)].copy()
        g.distance = self.distance[np.ix_(inv, inv)].copy()
        return g

    # ------------------------------------------------------------------
    # Kipf-Welling normalized adjacency
    # ------------------------------------------------------------------

    def norm_adj(self) -> np.ndarray:
        """D^{-1/2} (A + I) D^{-1/2} (reference ``DenseGraph.h:69-111``)."""
        a_tilde = self.adj.astype(np.float64) + np.eye(self.nVertices)
        deg = a_tilde.sum(axis=1)
        d_inv_sqrt = 1.0 / np.sqrt(deg)
        return a_tilde * d_inv_sqrt[:, None] * d_inv_sqrt[None, :]

    def __repr__(self) -> str:
        nEdges = int(np.triu(self.adj, 1).sum())
        return (
            f"DenseGraph(nVertices={self.nVertices}, nFeatures={self.nFeatures}, "
            f"nEdges={nEdges})"
        )
