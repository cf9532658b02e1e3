"""Generalized Steerable Convolutional Networks (GCN family) + relatives.

Covers the reference models:

  GCN_1D / GCN_2D / GCN_3D      (``GCN_1D.h`` etc.) — WL depth-bucketed
      features, per-level hidden = Softmax(W1 @ feat + W2 @ agg(neighbors)),
      neighbor radius min(l, max_Radius), aggregation of 1st/2nd/3rd order
      (RisiLayer1D/2D/3D; 3D adds KMax pooling to nHiddens,
      ``GCN_3D.h:77-87``), linear-regression head, Momentum.
  GCN_*_Distance                (``GCN_1D_Distance.h:98-161``) — a second
      channel whose per-vertex input is the SORTED distance column; heads
      concatenated ([2 nHiddens] regression weights).
  NeuralFingerprint             (``NeuralFingerprint.h:58-106``) — Duvenaud
      fingerprints: raw features at every level, open 1-hop SumVectors
      aggregation.
  GCN_MW                        (``GCN_MW.h:209-221``) — Kipf-Welling GCN:
      hidden_l = LeakyReLU(norm_adj @ hidden_{l-1} @ W_l), SumRows head.

Design: neighborhood aggregation is one masked matmul per level
(M_l @ hidden) where M_l[v, u] = [sp(v, u) <= min(l, R)]; the 2nd/3rd-order
RisiLayer products use the closed forms from ``graphflow_tpu.ops.reductions``
vectorized over vertices, so nothing exceeds O(V^2 H + V H^3) per level.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from graphflow_tpu.core import prep
from graphflow_tpu.core.graph import DenseGraph
from graphflow_tpu.models.base import GraphModel
from graphflow_tpu.ops import activations, losses


@dataclasses.dataclass
class GCNConfig:
    nLevels: int
    max_nVertices: int
    nFeatures: int
    nHiddens: int
    nDepth: int
    max_Radius: int
    order: int = 1                    # 1 | 2 | 3 (RisiLayer order)
    momentum_param: float = 0.9
    use_distance_channel: bool = False
    # Plain GCN_2D's neighbor rule is ``sp(v,u) <= l`` with NO max_Radius
    # cap (``GCN_2D.h:230``) — unlike GCN_1D/GCN_3D and every _Distance /
    # GRU variant, which use min(l, max_Radius).  A reference quirk
    # uncovered by the round-4 binary-parity harness.
    uncapped_radius: bool = False
    optimizer: str = "momentum"
    dtype: str = "float32"

    @property
    def feat_dim(self):
        return self.nFeatures * (self.nDepth + 1)


def init_gcn_params(key, cfg: GCNConfig):
    from graphflow_tpu.optim.utils import uniform_init

    dtype = jnp.dtype(cfg.dtype)
    n_keys = 4 * (cfg.nLevels + 1) + 2
    keys = iter(jax.random.split(key, n_keys))
    params = {"levels": []}
    for l in range(cfg.nLevels + 1):
        lev = {"W1": uniform_init(next(keys), (cfg.nHiddens, cfg.feat_dim),
                                  dtype)}
        if l > 0:
            lev["W2"] = uniform_init(next(keys),
                                     (cfg.nHiddens, cfg.nHiddens), dtype)
        params["levels"].append(lev)
    if cfg.use_distance_channel:
        params["dlevels"] = []
        for l in range(cfg.nLevels + 1):
            lev = {"W1": uniform_init(next(keys),
                                      (cfg.nHiddens, cfg.max_nVertices), dtype)}
            if l > 0:
                lev["W2"] = uniform_init(next(keys),
                                         (cfg.nHiddens, cfg.nHiddens), dtype)
            params["dlevels"].append(lev)
        params["W"] = uniform_init(next(keys), (2 * cfg.nHiddens,), dtype)
    else:
        params["W"] = uniform_init(next(keys), (cfg.nHiddens,), dtype)
    return params


def _aggregate(M, hidden, order: int, nHiddens: int):
    """Masked RisiLayer-{1,2,3}D over each vertex's neighbor set.

    M: [V, V] 0/1 neighborhood mask, hidden: [V, H].
    """
    if order == 1:
        return M @ hidden                                     # RisiLayer1D
    if order == 2:
        # Y_v = sum_u M_vu x_u (Stot_v - s_u), closed form of RisiLayer2D.h
        s = hidden.sum(axis=1)                                # [V]
        Stot = M @ s                                          # [V]
        return Stot[:, None] * (M @ hidden) - M @ (s[:, None] * hidden)
    if order == 3:
        # Inclusion-exclusion over ordered distinct triples (RisiLayer3D.h),
        # then KMax pooling to nHiddens (GCN_3D.h:84: KMax(neighbor, H)).
        u1 = M @ hidden                                       # [V, H]
        u2 = jnp.einsum("vu,ui,uj->vij", M, hidden, hidden)
        u3 = jnp.einsum("vu,ui,uj,uk->vijk", M, hidden, hidden, hidden)
        uuu = jnp.einsum("vi,vj,vk->vijk", u1, u1, u1)
        c12 = jnp.einsum("vij,vk->vijk", u2, u1)
        c13 = jnp.einsum("vik,vj->vijk", u2, u1)
        c23 = jnp.einsum("vi,vjk->vijk", u1, u2)
        Y = uuu - c12 - c13 - c23 + 2.0 * u3                  # [V, H, H, H]
        flat = Y.reshape(Y.shape[0], -1)
        return jnp.sort(flat, axis=1)[:, -nHiddens:]          # KMax (ascending)
    raise ValueError(order)


def _channel_forward(levels, feat, M_of, vmask, order, nHiddens,
                     collect=None):
    """One GCN channel: returns final [H] summed top-level hidden.

    ``collect``: optional list; per-level hidden [V, H] arrays are appended
    (the reference's ``level[l]->hidden`` activations, for parity tests and
    ForDebugging-style dumps)."""
    hidden = activations.softmax(feat @ levels[0]["W1"].T) * vmask[:, None]
    if collect is not None:
        collect.append(hidden)
    for l in range(1, len(levels)):
        part1 = feat @ levels[l]["W1"].T
        agg = _aggregate(M_of(l), hidden, order, nHiddens)
        part2 = agg @ levels[l]["W2"].T
        hidden = activations.softmax(part1 + part2) * vmask[:, None]
        if collect is not None:
            collect.append(hidden)
    return hidden.sum(axis=0), hidden


def gcn_states(params, g, cfg: GCNConfig):
    """Per-level hidden activations (list of [V, H]) + final feature —
    the reference's ``GCN_1D.h`` ``level[l]->hidden[v]`` / ``final_feature``
    internals, for binary-parity tests and debugging dumps."""
    vmask, sp = g["vmask"], g["sp"]

    def M_of(l):
        radius = l if cfg.uncapped_radius else min(l, cfg.max_Radius)
        return ((sp <= radius).astype(vmask.dtype)
                * vmask[:, None] * vmask[None, :])

    states = []
    final, _ = _channel_forward(params["levels"], g["wl_feat"], M_of, vmask,
                                cfg.order, cfg.nHiddens, collect=states)
    return states, final


def gcn_forward(params, g, cfg: GCNConfig):
    vmask = g["vmask"]
    sp = g["sp"]

    def M_of(l):
        radius = l if cfg.uncapped_radius else min(l, cfg.max_Radius)
        return ((sp <= radius).astype(vmask.dtype)
                * vmask[:, None] * vmask[None, :])

    final_vertex, _ = _channel_forward(params["levels"], g["wl_feat"], M_of,
                                       vmask, cfg.order, cfg.nHiddens)
    if not cfg.use_distance_channel:
        predict = jnp.dot(final_vertex, params["W"])
        return predict, final_vertex

    # Distance channel (GCN_1D_Distance.h:98-161): per-vertex input is the
    # ascending-sorted distance column, zero for padding slots.
    dist_col = g["dist"].T * vmask[:, None] * vmask[None, :]  # row v = d(:, v)
    dist_sorted = jnp.sort(dist_col, axis=1)
    # The distance channel aggregates with the SAME RisiLayer order as the
    # vertex channel (GCN_2D_Distance.h:141: neighbor[v] = RisiLayer2D;
    # GCN_3D_Distance likewise) — caught by the round-5 parity harness.
    final_distance, _ = _channel_forward(
        params["dlevels"], dist_sorted, M_of, vmask, cfg.order,
        cfg.nHiddens)
    final = jnp.concatenate([final_vertex, final_distance])
    return jnp.dot(final, params["W"]), final


class GCN(GraphModel):
    """GCN_{1,2,3}D (+_Distance) with the reference API."""

    def __init__(self, cfg: GCNConfig, seed: int = 0):
        super().__init__(optimizer=cfg.optimizer,
                         **({"gamma": cfg.momentum_param}
                            if cfg.optimizer == "momentum" else {}))
        self.cfg = cfg
        self.params = init_gcn_params(jax.random.PRNGKey(seed), cfg)
        # save_model/load_model are CHANNEL-BLOCKED — all vertex-channel
        # weights, then all distance-channel weights, then W — even though
        # the sgd registration interleaves the channels per level
        # (GCN_1D_Distance.h save/load vs :166-176).
        order = []
        for l in range(cfg.nLevels + 1):
            order.append(f"levels/{l}/W1")
            if l > 0:
                order.append(f"levels/{l}/W2")
        if cfg.use_distance_channel:
            for l in range(cfg.nLevels + 1):
                order.append(f"dlevels/{l}/W1")
                if l > 0:
                    order.append(f"dlevels/{l}/W2")
        order.append("W")
        self.param_order = order
        self._finish_init()

    def _prepare(self, graph: DenseGraph):
        return prep.prepare_graph(
            graph, self.cfg.nLevels, self.cfg.max_nVertices,
            max_receptive_field=1, nDepth=self.cfg.nDepth,
            dtype=np.dtype(self.cfg.dtype))

    def _forward(self, params, g):
        return gcn_forward(params, g, self.cfg)

    def _loss(self, params, g, target):
        pred, _ = gcn_forward(params, g, self.cfg)
        return losses.squared_loss(pred, target)


def GCN_1D(nLevels, max_nVertices, nFeatures, nHiddens, nDepth, max_Radius,
           momentum_param=0.9, seed=0) -> GCN:
    """``GCN_1D.h:30-41``."""
    return GCN(GCNConfig(nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                         max_Radius, order=1,
                         momentum_param=momentum_param), seed)


def GCN_2D(nLevels, max_nVertices, nFeatures, nHiddens, nDepth, max_Radius,
           momentum_param=0.9, seed=0) -> GCN:
    """``GCN_2D.h``: RisiLayer2D aggregation.  Note the reference quirk:
    plain GCN_2D's neighbor radius is ``l``, NOT min(l, max_Radius)
    (``GCN_2D.h:230``; the cap exists in every other family member)."""
    return GCN(GCNConfig(nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                         max_Radius, order=2, uncapped_radius=True,
                         momentum_param=momentum_param), seed)


def GCN_3D(nLevels, max_nVertices, nFeatures, nHiddens, nDepth, max_Radius,
           momentum_param=0.9, seed=0) -> GCN:
    """``GCN_3D.h``: RisiLayer3D + KMax aggregation."""
    return GCN(GCNConfig(nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                         max_Radius, order=3,
                         momentum_param=momentum_param), seed)


def GCN_1D_Distance(nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                    max_Radius, momentum_param=0.9, seed=0) -> GCN:
    """``GCN_1D_Distance.h``: + sorted-distance channel."""
    return GCN(GCNConfig(nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                         max_Radius, order=1, use_distance_channel=True,
                         momentum_param=momentum_param), seed)


def GCN_2D_Distance(nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                    max_Radius, momentum_param=0.9, seed=0) -> GCN:
    return GCN(GCNConfig(nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                         max_Radius, order=2, use_distance_channel=True,
                         momentum_param=momentum_param), seed)


def GCN_3D_Distance(nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                    max_Radius, momentum_param=0.9, seed=0) -> GCN:
    return GCN(GCNConfig(nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                         max_Radius, order=3, use_distance_channel=True,
                         momentum_param=momentum_param), seed)


# ----------------------------------------------------------------------
# Kipf-Welling GCN (GCN_MW)
# ----------------------------------------------------------------------

@dataclasses.dataclass
class GCNMWConfig:
    nLevels: int
    max_nVertices: int
    nFeatures: int
    nHiddens: int
    nDepth: int
    momentum_param: float = 0.9
    dtype: str = "float32"


class GCN_MW(GraphModel):
    """``GCN_MW.h``: hidden_l = LeakyReLU(norm_adj @ hidden_{l-1} @ W_l).

    ``aggregation``: "dense" (masked [V, V] matmul — right for the tiny
    padded molecules), "ell" (ELLPACK SpMM, ``ops/sparse.py`` — O(V D H),
    the large-graph path; requires nDepth == 0 since the sparse prep skips
    Floyd-Warshall), or "auto" (ell when max_nVertices >= 1024 and
    nDepth == 0).  Both paths compute the same normalized-adjacency
    aggregation (parity-tested)."""

    def __init__(self, nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                 momentum_param=0.9, seed=0, aggregation="auto"):
        super().__init__(optimizer="momentum", gamma=momentum_param)
        if aggregation == "auto":
            aggregation = ("ell" if max_nVertices >= 1024 and nDepth == 0
                           else "dense")
        if aggregation == "ell":
            assert nDepth == 0, "ELL aggregation requires nDepth == 0"
        self.aggregation = aggregation
        self.cfg = GCNMWConfig(nLevels, max_nVertices, nFeatures, nHiddens,
                               nDepth, momentum_param)
        from graphflow_tpu.optim.utils import uniform_init
        cfg = self.cfg
        feat_dim = nFeatures * (nDepth + 1)
        keys = iter(jax.random.split(jax.random.PRNGKey(seed), nLevels + 2))
        self.params = {
            "levels": [
                {"W": uniform_init(next(keys),
                                   (feat_dim if l == 0 else nHiddens,
                                    nHiddens), jnp.float32)}
                for l in range(nLevels + 1)],
            "W": uniform_init(next(keys), (nHiddens,), jnp.float32),
        }
        self.param_order = [f"levels/{l}/W" for l in range(nLevels + 1)] + ["W"]
        self._finish_init()

    def _prepare(self, graph):
        if self.aggregation == "ell":
            return prep.prepare_graph_sparse(graph, self.cfg.max_nVertices)
        return prep.prepare_graph(graph, self.cfg.nLevels,
                                  self.cfg.max_nVertices,
                                  max_receptive_field=1,
                                  nDepth=self.cfg.nDepth)

    def _forward(self, params, g):
        from graphflow_tpu.ops.sparse import ell_spmm

        hidden = g["wl_feat"]
        for lev in params["levels"]:
            if "ell_nbr" in g:
                hidden = ell_spmm(g["ell_nbr"], g["ell_w"],
                                  hidden @ lev["W"])
            else:
                hidden = g["norm_adj"] @ hidden @ lev["W"]
            hidden = activations.leaky_relu(hidden)
            hidden = hidden * g["vmask"][:, None]
        final = hidden.sum(axis=0)                 # SumRows head (GCN_MW.h)
        return jnp.dot(final, params["W"]), final

    def _loss(self, params, g, target):
        pred, _ = self._forward(params, g)
        return losses.squared_loss(pred, target)


# ----------------------------------------------------------------------
# Neural Graph Fingerprint (Duvenaud)
# ----------------------------------------------------------------------

def nf_states(params, g, nLevels):
    """NeuralFingerprint per-level hidden activations + final feature
    (``NeuralFingerprint.h:58-106`` ``level[l]->hidden`` internals).
    Returns (list of [V, H] per level, final [H])."""
    from graphflow_tpu.ops.sparse import ell_spmm

    feat, vmask = g["raw_feat"], g["vmask"]
    if "ell_nbr_a" not in g:
        M = g["adj"] * vmask[:, None] * vmask[None, :]       # open 1-hop
    hidden = activations.softmax(
        feat @ params["levels"][0]["W1"].T) * vmask[:, None]
    states = [hidden]
    for l in range(1, nLevels + 1):
        part1 = feat @ params["levels"][l]["W1"].T
        if "ell_nbr_a" in g:
            agg = ell_spmm(g["ell_nbr_a"], g["ell_w_a"], hidden)
        else:
            agg = M @ hidden
        part2 = agg @ params["levels"][l]["W2"].T
        hidden = activations.softmax(part1 + part2) * vmask[:, None]
        states.append(hidden)
    return states, hidden.sum(axis=0)


class NeuralFingerprint(GraphModel):
    """``NeuralFingerprint.h``: raw features at every level, open 1-hop
    SumVectors aggregation, Softmax units, Momentum."""

    def __init__(self, nLevels, max_nVertices, nFeatures, nHiddens,
                 momentum_param=0.9, seed=0, aggregation="auto"):
        super().__init__(optimizer="momentum", gamma=momentum_param)
        from graphflow_tpu.optim.utils import uniform_init
        if aggregation == "auto":
            aggregation = "ell" if max_nVertices >= 1024 else "dense"
        self.aggregation = aggregation
        self.nLevels, self.max_nVertices = nLevels, max_nVertices
        self.nFeatures, self.nHiddens = nFeatures, nHiddens
        keys = iter(jax.random.split(jax.random.PRNGKey(seed),
                                     2 * (nLevels + 1) + 1))
        self.params = {"levels": [], "W": None}
        for l in range(nLevels + 1):
            lev = {"W1": uniform_init(next(keys), (nHiddens, nFeatures),
                                      jnp.float32)}
            if l > 0:
                lev["W2"] = uniform_init(next(keys), (nHiddens, nHiddens),
                                         jnp.float32)
            self.params["levels"].append(lev)
        self.params["W"] = uniform_init(next(keys), (nHiddens,), jnp.float32)
        order = []
        for l in range(nLevels + 1):
            order.append(f"levels/{l}/W1")
            if l > 0:
                order.append(f"levels/{l}/W2")
        self.param_order = order + ["W"]
        self._finish_init()

    def _prepare(self, graph):
        if self.aggregation == "ell":
            return prep.prepare_graph_sparse(graph, self.max_nVertices)
        return prep.prepare_graph(graph, self.nLevels, self.max_nVertices,
                                  max_receptive_field=1, nDepth=0,
                                  use_wl_features=False)

    def _forward(self, params, g):
        _, final = nf_states(params, g, self.nLevels)
        return jnp.dot(final, params["W"]), final

    def _loss(self, params, g, target):
        pred, _ = self._forward(params, g)
        return losses.squared_loss(pred, target)


def gcn_inspect(model, graph) -> dict:
    """Activation dump for debugging (ForDebugging-style, mirroring
    ``smp2d.smp2d_inspect``): per-level hiddens and the final feature as
    NumPy arrays restricted to real vertices."""
    import numpy as np

    batch = model._stack([graph])
    g = jax.tree_util.tree_map(lambda x: x[0], batch)
    states, final = gcn_states(model.params, g, model.cfg)
    n = graph.nVertices
    return {
        "states": [np.asarray(s)[:n] for s in states],
        "final_feature": np.asarray(final),
    }
