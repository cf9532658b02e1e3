"""Host-side graph preprocessing pipeline.

The reference rebuilds a dynamic computation graph per example
(``SMP_omega.h:584-693``); all the data-dependent work happens there:
Floyd-Warshall shortest paths (``SMP_omega.h:358-380``), Weisfeiler-Lehman
depth-bucketed features (``:382-404``), vertex ranking (``:418-434``),
receptive-field construction with capping (``:476-582``), permutation
matrices and reduced adjacency.

Design: all of this is *data preparation*, not differentiable
compute, so it runs on host as NumPy and emits **static-shaped index arrays**.
The dense permutation matrices X[v][w] of the reference become integer gather
indices (``pos``), and "multiply by a permutation matrix" on device becomes a
vectorized take with a zero-padding sentinel.  This is what lets the whole
model be traced once by XLA instead of rebuilt per molecule.

A faithfulness note: the reference's vertex ranking uses a *non-stable*
exchange sort (``SMP_omega.h:418-434``); we replicate it exactly so that
tie-breaking (e.g. between symmetric hydrogens in CH4) matches the reference
receptive-field orderings bit-for-bit.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from graphflow_tpu.core.graph import DenseGraph

INF = 10**9  # reference GCN_1D.h:26 `const int INF = 1e9`


# ----------------------------------------------------------------------
# Shortest paths + WL features + ranking
# ----------------------------------------------------------------------

def floyd_warshall(adj: np.ndarray) -> np.ndarray:
    """All-pairs shortest paths (hop counts) a la ``SMP_omega.h:358-380``.

    Vectorized min-plus matrix closure instead of the reference's triple loop.
    Unreachable pairs keep the reference's INF = 1e9 convention.
    """
    n = adj.shape[0]
    sp = np.full((n, n), INF, dtype=np.int64)
    np.fill_diagonal(sp, 0)
    sp[adj > 0] = 1
    sp = np.minimum(sp, sp.T)
    # Min-plus closure by repeated squaring: O(V^3 log V) but fully vectorized.
    hops = 1
    while hops < n:
        sp = np.minimum(sp, (sp[:, :, None] + sp[None, :, :]).min(axis=1))
        hops *= 2
    return np.minimum(sp, INF)


def wl_features(sp: np.ndarray, feature: np.ndarray, nDepth: int) -> np.ndarray:
    """Depth-bucketed Weisfeiler-Lehman feature histograms.

    ``hist[v, d*F + f] = sum_{u : sp[u,v] == d} feature[u, f]`` for
    d in [0, nDepth] (reference ``SMP_omega.h:382-404``).
    """
    n, F = feature.shape
    hist = np.zeros((n, (nDepth + 1) * F), dtype=feature.dtype)
    for d in range(nDepth + 1):
        sel = (sp == d).astype(feature.dtype)  # sel[u, v]
        hist[:, d * F:(d + 1) * F] = sel.T @ feature
    return hist


def rank_vertices(hist: np.ndarray):
    """Rank vertices by descending lexicographic order of their histograms.

    Replicates the reference's exchange sort (``SMP_omega.h:418-434``)
    *exactly*, including its non-stable behavior on tied histograms:
    ``for i: for j>i: if hist[order[i]] <lex hist[order[j]]: swap``.

    Returns (order, rank): ``order[i]`` = vertex at sorted position i,
    ``rank[v]`` = sorted position of vertex v.
    """
    n = hist.shape[0]
    keys = [tuple(hist[v]) for v in range(n)]
    order = list(range(n))
    for i in range(n):
        for j in range(i + 1, n):
            if keys[order[i]] < keys[order[j]]:
                order[i], order[j] = order[j], order[i]
    rank = np.empty(n, dtype=np.int64)
    for i, v in enumerate(order):
        rank[v] = i
    return np.asarray(order, dtype=np.int64), rank


# ----------------------------------------------------------------------
# Receptive fields
# ----------------------------------------------------------------------

def _limit_receptive_field(v: int, A: List[int], sp: np.ndarray,
                           rank: Optional[np.ndarray], cap: int
                           ) -> List[int]:
    """Cap a receptive field (reference ``SMP_omega.h:476-507``).

    Sort by (distance from v, rank) ascending, then drop *whole* trailing
    distance groups until the size fits the cap (the reference pops the entire
    farthest-distance group each round, possibly undershooting the cap).

    With ``rank=None`` (the pairgraphs/no-WL models,
    ``SMP_omega_pairgraphs.h:468-493``), the reference sorts by distance
    ONLY via its exchange sort — which is NOT stable (e.g. keys
    [2a, 2b, 1c] come out [1c, 2b, 2a], reversing the tied pair) — so the
    exact double-loop swap sequence is replicated here for bit parity.
    """
    if rank is None:
        A = list(A)
        for i in range(len(A)):
            for j in range(i + 1, len(A)):
                if sp[v, A[i]] > sp[v, A[j]]:
                    A[i], A[j] = A[j], A[i]
    else:
        A = sorted(A, key=lambda u: (sp[v, u], rank[u]))
    while len(A) > cap:
        d = sp[v, A[-1]]
        while A and sp[v, A[-1]] == d:
            A.pop()
    assert 0 < len(A) <= cap and A[0] == v
    return A


def receptive_fields(sp: np.ndarray, rank: np.ndarray, nLevels: int,
                     max_receptive_field: Optional[int],
                     has_WL_ordering: bool = True) -> List[List[List[int]]]:
    """Multi-level receptive fields phi[l][v] (reference ``SMP_omega.h:509-538``).

    phi[0][v] = [v]; phi[l][v] = union over closed neighbors u of phi[l-1][u]
    in first-seen order, capped to ``max_receptive_field`` (None = uncapped,
    the SMP_beta behavior, ``SMP_beta.h:199-208``), then sorted by WL rank.
    """
    n = sp.shape[0]
    phi: List[List[List[int]]] = [[[v] for v in range(n)]]
    for l in range(1, nLevels + 1):
        phi_l = []
        for v in range(n):
            acc: List[int] = []
            seen = set()
            for u in range(n):
                if sp[u, v] <= 1:
                    for w in phi[l - 1][u]:
                        if w not in seen:
                            seen.add(w)
                            acc.append(w)
            if max_receptive_field is not None and len(acc) > max_receptive_field:
                acc = _limit_receptive_field(
                    v, acc, sp, rank if has_WL_ordering else None,
                    max_receptive_field)
            if has_WL_ordering:
                acc = sorted(acc, key=lambda u: rank[u])
            phi_l.append(acc)
        phi.append(phi_l)
    return phi


# ----------------------------------------------------------------------
# Prepared graph: static-shaped device-ready index arrays
# ----------------------------------------------------------------------

@dataclasses.dataclass
class PreparedGraph:
    """Static-shaped arrays describing one preprocessed graph.

    Shapes (V = max_nVertices, P = max_receptive_field, L = nLevels):
      wl_feat   [V, F*(nDepth+1)]  WL features (or raw features, physics mode)
      vmask     [V]                1.0 for real vertices
      sizes     [L+1, V]           |phi_l(v)|  (0 for padding vertices)
      nbr       [L, V, P]          phi_l(v)[i]; padding slots point at vertex 0
      pos       [L, V, P, P]       pos[l-1, v, i, p] = index of phi_l(v)[p] in
                                   phi_{l-1}(w_i), or the sentinel P when
                                   absent (reads a zero pad row on device)
      radj      [L, V, P, P]       reduced adjacency (or Coulomb) per (l, v),
                                   zero outside the valid [s, s] block
      smask     [L+1, V, P, P]     spatial validity masks (p1 < s) & (p2 < s)

    The sentinel-P convention replaces the reference's dense permutation
    matrices (``SMP_omega.h:540-553``): gathering with index P from a spatially
    zero-padded state tensor contributes exact zeros, which is what
    X . f . X^T produces for vertices absent from the neighbor's field.
    """
    wl_feat: Optional[np.ndarray] = None
    vmask: Optional[np.ndarray] = None
    sizes: Optional[np.ndarray] = None
    nbr: Optional[np.ndarray] = None
    pos: Optional[np.ndarray] = None
    radj: Optional[np.ndarray] = None
    smask: Optional[np.ndarray] = None
    nVertices: int = 0
    # Raw per-graph payloads some heads need:
    norm_adj: Optional[np.ndarray] = None   # [V, V] Kipf-Welling, zero-padded
    adj: Optional[np.ndarray] = None        # [V, V] 0/1 adjacency, zero-padded
    sp: Optional[np.ndarray] = None         # [V, V] shortest paths (INF off-graph)
    raw_feat: Optional[np.ndarray] = None   # [V, F] raw (pre-WL) features
    dist: Optional[np.ndarray] = None       # [V, V] geometric distances, zero-pad
    # Sparse (ELLPACK) 1-hop aggregation structures (ops/sparse.py); present
    # only when built by prepare_graph_sparse:
    ell_nbr: Optional[np.ndarray] = None    # [V, D] int32, sentinel V
    ell_w: Optional[np.ndarray] = None      # [V, D] norm-adj weights
    ell_nbr_a: Optional[np.ndarray] = None  # [V, D] 0/1-adjacency variant
    ell_w_a: Optional[np.ndarray] = None    # [V, D]
    # First-order sparse aggregation (smp1d at production V): per level,
    # per (v, p) the flat (w*P + q) indices of the previous-level state
    # rows that sum into sum_v[p] — i.e. {(w, q) : sp(v, w) <= 1 and
    # phi_{l-1}(w)[q] == phi_l(v)[p]}, sentinel V*P.  Built only when
    # ``prepare_graph(..., fo_degree=D)`` is given.
    fo_idx: Optional[np.ndarray] = None     # [L, V, P, D] int32


def prepare_graph(
    graph: DenseGraph,
    nLevels: int,
    max_nVertices: int,
    max_receptive_field: Optional[int],
    nDepth: int,
    has_WL_ordering: bool = True,
    use_coulomb: bool = False,
    use_wl_features: bool = True,
    dtype=np.float32,
    backend: str = "auto",
    fo_degree: Optional[int] = None,
) -> PreparedGraph:
    """Run the full host pipeline for one graph.

    Mirrors ``SMP_omega::complete_computation_graph`` preprocessing steps
    (``SMP_omega.h:584-604``) and emits padded index arrays instead of a
    dynamic computation graph.  ``use_wl_features=False`` reproduces the
    ``*_physics`` variants which feed raw features only
    (``SMP_omega_physics.h``); ``use_coulomb=True`` swaps the 0/1 reduced
    adjacency for the Coulomb matrix (``SMP_omega.h:567-577``).

    ``backend="auto"`` uses the native C++ pipeline
    (``graphflow_tpu/runtime/graph_prep.cpp``) when its shared library is
    available (bit-identical results, ~3x faster); "python" forces the
    NumPy reference implementation.
    """
    if backend == "auto" and fo_degree is None:
        try:
            from graphflow_tpu.runtime import native
            if native.available():
                return native.prepare_graph_native(
                    graph, nLevels, max_nVertices, max_receptive_field,
                    nDepth, has_WL_ordering=has_WL_ordering,
                    use_coulomb=use_coulomb, use_wl_features=use_wl_features,
                    dtype=dtype)
        except Exception:
            pass  # fall through to the NumPy pipeline
    n = graph.nVertices
    V = max_nVertices
    assert n <= V, f"graph has {n} vertices > max_nVertices={V}"
    P = max_receptive_field if max_receptive_field is not None else V
    L = nLevels
    F = graph.nFeatures

    sp = floyd_warshall(graph.adj)
    hist = wl_features(sp, graph.feature, nDepth)
    _, rank = rank_vertices(hist)
    phi = receptive_fields(sp, rank, L, max_receptive_field, has_WL_ordering)

    feat_dim = F * (nDepth + 1) if use_wl_features else F
    wl_feat = np.zeros((V, feat_dim), dtype=dtype)
    wl_feat[:n] = hist.astype(dtype) if use_wl_features else graph.feature.astype(dtype)

    vmask = np.zeros((V,), dtype=dtype)
    vmask[:n] = 1.0

    sizes = np.zeros((L + 1, V), dtype=np.int32)
    nbr = np.zeros((L, V, P), dtype=np.int32)
    pos = np.full((L, V, P, P), P, dtype=np.int32)
    radj = np.zeros((L, V, P, P), dtype=dtype)
    smask = np.zeros((L + 1, V, P, P), dtype=dtype)

    for l in range(L + 1):
        for v in range(n):
            s = len(phi[l][v])
            assert s <= P
            sizes[l, v] = s
            smask[l, v, :s, :s] = 1.0

    for l in range(1, L + 1):
        for v in range(n):
            phiv = phi[l][v]
            s = len(phiv)
            for i, w in enumerate(phiv):
                nbr[l - 1, v, i] = w
                # position of each phi_l(v)[p] inside phi_{l-1}(w)
                lookup = {u: q for q, u in enumerate(phi[l - 1][w])}
                for p, u in enumerate(phiv):
                    pos[l - 1, v, i, p] = lookup.get(u, P)
            # Reduced adjacency (reference SMP_omega.h:555-581)
            for i, v1 in enumerate(phiv):
                for j, v2 in enumerate(phiv):
                    if use_coulomb:
                        radj[l - 1, v, i, j] = graph.coulomb[v1, v2]
                    elif v1 == v2:
                        radj[l - 1, v, i, j] = 1.0
                    else:
                        radj[l - 1, v, i, j] = graph.adj[v1, v2]

    na = np.zeros((V, V), dtype=dtype)
    na[:n, :n] = graph.norm_adj().astype(dtype)
    adj_pad = np.zeros((V, V), dtype=dtype)
    adj_pad[:n, :n] = (graph.adj[:n, :n] > 0).astype(dtype)
    sp_pad = np.full((V, V), INF, dtype=np.int64)
    sp_pad[:n, :n] = sp
    raw = np.zeros((V, F), dtype=dtype)
    raw[:n] = graph.feature.astype(dtype)
    dist_pad = np.zeros((V, V), dtype=dtype)
    dist_pad[:n, :n] = graph.distance.astype(dtype)

    fo_idx = None
    if fo_degree is not None:
        # First-order sparse aggregation indices (PreparedGraph.fo_idx):
        # for each (l, v, p) the flat (w * P + q) rows of the previous
        # level's [V, P, C] state that sum into sum_v[p].
        fo_idx = np.full((L, V, P, fo_degree), V * P, dtype=np.int32)
        closed = (graph.adj[:n, :n] > 0) | np.eye(n, dtype=bool)
        for l in range(1, L + 1):
            # POS[w, u] = position of vertex u inside phi_{l-1}(w), else -1.
            POS = np.full((n, n), -1, dtype=np.int64)
            for w in range(n):
                POS[w, np.asarray(phi[l - 1][w], dtype=np.int64)] = (
                    np.arange(len(phi[l - 1][w])))
            for v in range(n):
                u_list = np.asarray(phi[l][v], dtype=np.int64)   # [s]
                Wn = np.nonzero(closed[v])[0]                    # [deg]
                Q = POS[np.ix_(Wn, u_list)]                      # [deg, s]
                valid = Q >= 0
                counts = valid.sum(axis=0)
                assert counts.max(initial=0) <= fo_degree, (
                    f"fo_degree={fo_degree} < closed degree "
                    f"{int(counts.max())} at level {l} vertex {v}")
                ii, jj = np.nonzero(valid)
                ranks = valid.cumsum(axis=0)[ii, jj] - 1
                fo_idx[l - 1, v, jj, ranks] = Wn[ii] * P + Q[ii, jj]

    return PreparedGraph(
        wl_feat=wl_feat, vmask=vmask, sizes=sizes, nbr=nbr, pos=pos,
        radj=radj, smask=smask, nVertices=n,
        norm_adj=na, adj=adj_pad, sp=sp_pad, raw_feat=raw, dist=dist_pad,
        fo_idx=fo_idx,
    )


def prepare_graph_sparse(graph, max_nVertices: int,
                         max_degree: Optional[int] = None,
                         dtype=np.float32) -> PreparedGraph:
    """Light host prep for the 1-hop sparse-aggregation models
    (GCN_MW / NeuralFingerprint with ``aggregation="ell"``).

    Skips the O(V^3) Floyd-Warshall and every dense [V, V] intermediate —
    the aggregation structures are ELLPACK neighbor lists built straight
    from the edge set (``graphflow_tpu.ops.sparse``), so graphs with
    V >= thousands prepare in O(E).  ``graph`` is a DenseGraph or a
    ``(nVertices, edges, features)`` tuple (the edge-list form avoids ever
    materializing a dense adjacency on host).
    """
    from graphflow_tpu.ops import sparse as sparse_ops

    if isinstance(graph, DenseGraph):
        n = graph.nVertices
        edges = [(int(u), int(v))
                 for (u, v) in np.argwhere(np.triu(graph.adj, 1) > 0)]
        features = graph.feature
    else:
        n, edges, features = graph
    V = max_nVertices
    assert n <= V
    F = np.asarray(features).shape[1]

    wl_feat = np.zeros((V, F), dtype=dtype)
    wl_feat[:n] = np.asarray(features, dtype=dtype)
    vmask = np.zeros((V,), dtype=dtype)
    vmask[:n] = 1.0

    nbr_n, w_n = sparse_ops.norm_adj_ell(n, edges, pad_rows=V,
                                         max_degree=max_degree)
    nbr_a, w_a = sparse_ops.ell_from_edges(n, edges, pad_rows=V,
                                           max_degree=max_degree)
    return PreparedGraph(
        wl_feat=wl_feat, vmask=vmask, nVertices=n, raw_feat=wl_feat,
        ell_nbr=nbr_n, ell_w=w_n.astype(dtype),
        ell_nbr_a=nbr_a, ell_w_a=w_a.astype(dtype),
    )
