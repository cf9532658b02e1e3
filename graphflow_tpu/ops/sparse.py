"""Sparse neighbor aggregation (SpMM) for the 1-hop GNN families.

The reference aggregates neighbors with per-vertex scalar loops
(``NeuralFingerprint.h:58-82``, ``GCN_MW.h:209-221``, ``GCN_1D.h:213-260``);
the first versions of this framework used dense masked [V, V] matmuls —
fine at V<=64, the wrong asymptotic for large graphs (BASELINE.json's
first metric is edges/s per device for SpMM aggregation).

Sparse design: **ELLPACK**.

  * ELLPACK pads every vertex's neighbor list to a common max degree D:
    ``agg[v] = sum_d w[v, d] * h[nbr[v, d]]``.  The gather is ONE flat
    row-take and the weighted reduction is a [V, D] x [V, D, H] einsum.
    Memory/FLOPs are O(V D H) instead of the dense O(V^2 H).
  * It pays for the maximum degree; a CSR / segment-sum form (the GPU's
    native idiom, ``coo_spmm`` below) has not been measured on the GPU
    yet (ROADMAP S4).

A COO segment-sum variant is provided for CPU-side parity checking; the
dense path remains the right choice for the tiny padded molecules
(V <= ~256) where D ~ V anyway.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


# ----------------------------------------------------------------------
# Host-side format builders
# ----------------------------------------------------------------------

def ell_from_adj(adj: np.ndarray, weights: Optional[np.ndarray] = None,
                 max_degree: Optional[int] = None,
                 pad_rows: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Dense (possibly weighted) adjacency -> ELLPACK (nbr, w).

    Returns ``nbr [V, D] int32`` (sentinel V for padding slots) and
    ``w [V, D]`` float weights (0 at padding).  ``weights`` defaults to
    ``adj`` itself (so a 0/1 adjacency gives unit weights and a
    normalized adjacency gives its coefficients).
    """
    V = adj.shape[0]
    Vp = pad_rows or V
    w_src = adj if weights is None else weights
    rows = [np.nonzero(adj[v])[0] for v in range(V)]
    D = max_degree or max((len(r) for r in rows), default=1) or 1
    nbr = np.full((Vp, D), Vp, np.int32)
    w = np.zeros((Vp, D), w_src.dtype)
    for v, r in enumerate(rows):
        assert len(r) <= D, f"vertex {v} degree {len(r)} > D={D}"
        nbr[v, :len(r)] = r
        w[v, :len(r)] = w_src[v, r]
    return nbr, w


def ell_from_edges(n: int, edges, weights=None,
                   max_degree: Optional[int] = None,
                   pad_rows: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Undirected edge list -> ELLPACK without materializing [V, V].

    ``weights`` maps edge index -> weight (default 1.0 both directions).
    """
    Vp = pad_rows or n
    adj_lists = [[] for _ in range(n)]
    wts = [[] for _ in range(n)]
    for e, (u, v) in enumerate(edges):
        wv = 1.0 if weights is None else float(weights[e])
        adj_lists[u].append(v)
        wts[u].append(wv)
        if u != v:
            adj_lists[v].append(u)
            wts[v].append(wv)
    D = max_degree or max((len(r) for r in adj_lists), default=1) or 1
    nbr = np.full((Vp, D), Vp, np.int32)
    w = np.zeros((Vp, D), np.float32)
    for v in range(n):
        r = adj_lists[v]
        assert len(r) <= D
        nbr[v, :len(r)] = r
        w[v, :len(r)] = wts[v]
    return nbr, w


def norm_adj_ell(n: int, edges, pad_rows: Optional[int] = None,
                 max_degree: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Kipf-Welling normalized adjacency D^-1/2 (A+I) D^-1/2 directly in
    ELLPACK form (``DenseGraph.h:69-111`` semantics) — per-entry weight
    1/sqrt((deg_u + 1)(deg_v + 1)) including the self loop — without the
    O(V^2) dense intermediate."""
    deg = np.zeros(n, np.int64)
    for (u, v) in edges:
        if u != v:
            deg[u] += 1
            deg[v] += 1
    inv = 1.0 / np.sqrt(deg + 1.0)
    ed = list(edges) + [(v, v) for v in range(n)]
    wts = [inv[u] * inv[v] for (u, v) in ed]
    return ell_from_edges(n, ed, wts, max_degree=max_degree,
                          pad_rows=pad_rows)


# ----------------------------------------------------------------------
# Device kernels
# ----------------------------------------------------------------------

def ell_spmm(nbr: jnp.ndarray, w: jnp.ndarray, h: jnp.ndarray) -> jnp.ndarray:
    """ELLPACK SpMM: ``out[v] = sum_d w[v, d] * h[nbr[v, d]]``.

    nbr: [V, D] int32 with sentinel V for padding (w is 0 there);
    w: [V, D]; h: [V, H].

    Formulation (chosen by an A/B on the previous accelerator,
    tools/bench_spmm{,2}.py at V=8192 D=16 H=64; not yet re-run on the
    GPU): ONE flat row gather of all V*D rows with ``promise_in_bounds``
    (sentinels clamped to a real row — its value is annihilated by
    w == 0, so no [h; 0] concat copy and no per-index clamp in the
    gather) followed by one batched reduction at HIGHEST precision
    (exact f32 accumulation; the op moves bytes, so precision is free).

    Caveat: because sentinels are CLAMPED to a real row and
    annihilated by w == 0, a non-finite value in ``h`` (inf/NaN from a
    diverging run) leaks NaN into padded-slot outputs (0 * inf = NaN),
    where the old [h; 0] concat formulation stayed finite.  Accepted for
    the measured speedup — finite inputs are the contract; debug paths
    that must survive non-finite states should concat a zero row instead.
    """
    V, H = h.shape
    D = nbr.shape[1]
    acc_dt = jnp.promote_types(h.dtype, jnp.float32)
    ids = jnp.minimum(nbr.reshape(-1), V - 1)
    gathered = h.at[ids].get(mode="promise_in_bounds").reshape(V, D, H)
    return jnp.einsum("vd,vdh->vh", w, gathered.astype(acc_dt),
                      preferred_element_type=acc_dt,
                      precision=jax.lax.Precision.HIGHEST
                      ).astype(h.dtype)


def coo_spmm(src_idx: jnp.ndarray, dst_idx: jnp.ndarray, w: jnp.ndarray,
             h: jnp.ndarray, num_vertices: int) -> jnp.ndarray:
    """COO segment-sum SpMM (parity/CPU path): scatter-adds
    ``w_e * h[src_e]`` into ``dst_e``."""
    contrib = h[src_idx] * w[:, None].astype(h.dtype)
    return jax.ops.segment_sum(contrib, dst_idx,
                               num_segments=num_vertices)


def edges_count(nbr: np.ndarray) -> int:
    """Number of real (directed) entries in an ELLPACK structure."""
    V = nbr.shape[0]
    return int((np.asarray(nbr) < V).sum())
