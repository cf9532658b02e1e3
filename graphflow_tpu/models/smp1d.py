"""First-order Steerable Message Passing (vertex state = |phi| x C matrix).

One config-driven module covering the reference's first-order SMP models:

  SMP_1D               (``SMP_1D.h``)    — steerable filter W = l1*I + l2*1
                                           applied spatially, Momentum
  SMP_theta            (``SMP_theta.h``) — [l1*sum ; l2*1@sum] concat -> K
                                           (2C->C), receptive-field cap, Adam
  Unrestricted_SMP_1D  (``Unrestricted_SMP_1D.h:98-103``) — full learned
                                           W[size] per receptive-field size
  *_classification     — LogLoss head
(CCN_1D — the theta architecture with pair-of-graphs input, ``CCN_1D.h`` —
lives in graphflow_tpu.models.pairgraphs.)

Math per level (reference ``SMP_theta.h:570-615`` / ``SMP_1D.h:480-512``):
  level 0:  f_v = LeakyReLU((H @ wl_feat_v)^T)        (1 x C matrix)
  level l:  sum_v = SUM_{w : sp(v,w) <= 1} X[v][w] @ f_w   (s x C)
            theta:        f = LeakyReLU([l1[s]*sum ; l2[s]*(1 @ sum)] K + b[s])
            steerable:    f = LeakyReLU((l1[s] I + l2[s] 1) @ sum + b[s])
            unrestricted: f = LeakyReLU(W[s] @ sum + b[s])
  head:     vertex = LeakyReLU(column sums);  graph = SUM_v vertex;
            <graph, W> -> SquaredLoss   (or class scores -> LogLoss)

Note the per-SIZE parameters: lambda1/lambda2/b are indexed by |phi_l(v)|
(reference ``SMP_theta.h:166-187``) — stored here as dense [V+1]-indexed
arrays and gathered per vertex.

Vectorized neighbor sum: instead of per-(v,w) permutation matmuls, each
level's states are scattered into vertex-id space G[w, u, c], the 1-hop sum
becomes ONE matmul (adj1 @ G), and the result is gathered back into each
receptive field's local ordering.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from graphflow_tpu.core import prep
from graphflow_tpu.core.graph import DenseGraph
from graphflow_tpu.models.base import GraphModel
from graphflow_tpu.ops import activations, losses


@dataclasses.dataclass
class SMP1DConfig:
    max_nVertices: int
    max_receptive_field: Optional[int]
    nLevels: int
    nChanels: int
    nFeatures: int
    nDepth: int
    # "theta"        — [l1*sum ; l2*1@sum] @ K (2C->C), constant channels
    # "steerable"    — (l1 I + l2 1) @ sum, constant channels
    # "concat"       — [l1*sum ; l2*1@sum] concat, channels DOUBLE per level
    #                  (``SMP_1D_ver2.h:131-166``: no K reducer)
    # "concat_kk"    — concat of (l1*sum)@K_eye and (l2*1@sum)@K_one, channel
    #                  growth (``SMP_1D_ver3.h:142-175,542-549``)
    # "unrestricted" — full W[size] spatial filter, constant channels
    # "unrestricted2"— [W1[s]@sum ; W2[s]@sum] concat, channel growth
    #                  (``Unrestricted_SMP_1D_ver2.h:102-137``)
    filter: str = "theta"
    has_WL_ordering: bool = True
    use_wl_features: bool = True
    # CCN_1D L1-normalizes each vertex's raw feature vector before H
    # (``CCN_1D.h:440-448``); no other first-order model does.
    l1_normalize_features: bool = False
    # The channel-GROWING variants pass alpha = 0 to every tower
    # LeakyReLU2D — i.e. plain ReLU (``SMP_1D_ver2.h:491,534``,
    # ``SMP_1D_ver3.h:506,555``, ``Unrestricted_SMP_1D_ver2.h:458,498``);
    # the head's vertex LeakyReLU keeps the 0.01 default in ALL models
    # (``SMP_1D_ver2.h:546``).  Caught by the round-5 binary-parity
    # harness — divergence invisible to convergence tests.
    tower_alpha: float = 0.01
    # Production-scale aggregation: when set (max CLOSED vertex degree of
    # the expected graphs), the 1-hop sum runs as one flat-gather ELL SpMM
    # over precomputed (w, q) row indices — O(V P D C) — instead of the
    # id-space one-hot matmuls, whose O(V^2 (P + C)) einsums and [V, V, C]
    # intermediate are fine at molecule scale but crawl at V >= 4096.
    # Bit-exact: each output element is the same
    # exact sum, accumulated in f32 either way.
    sparse_max_degree: Optional[int] = None
    # Reproduce the reference's SHARED-NODE lambda gradients (prefix-sum
    # overcounting over same-size vertices — see
    # activations.persize_gather_refgrad); False = true gradients.
    faithful_lambda_grads: bool = True
    nClasses: Optional[int] = None
    optimizer: str = "adam"
    dtype: str = "float32"
    # Explicit per-level channel counts (length nLevels+1).  The pairgraph
    # towers HALVE channels each level (``SMP_theta_pairgraphs.h:210-212``:
    # C_l = max(C_{l-1}/2, 1)); None = the filter's default schedule.
    channel_schedule: Optional[tuple] = None

    @property
    def feat_dim(self) -> int:
        return (self.nFeatures * (self.nDepth + 1)
                if self.use_wl_features else self.nFeatures)

    @property
    def P(self) -> int:
        return (self.max_receptive_field
                if self.max_receptive_field is not None else self.max_nVertices)

    def channels_at(self, l: int) -> int:
        """Channel count of the level-l state.  The ver2/ver3 and
        Unrestricted-ver2 families double channels each level
        (``SMP_1D_ver2.h:131``: C_l = 2 C_{l-1})."""
        if self.channel_schedule is not None:
            return self.channel_schedule[l]
        if self.filter in ("concat", "concat_kk", "unrestricted2"):
            return self.nChanels * (2 ** l)
        return self.nChanels


def init_smp1d_params(key, cfg: SMP1DConfig):
    from graphflow_tpu.optim.utils import uniform_init

    dtype = jnp.dtype(cfg.dtype)
    V1 = cfg.max_nVertices + 1  # per-size params, index by |phi| in [1, V]
    keys = jax.random.split(key, 2 + 6 * cfg.nLevels)
    ki = iter(keys)
    # H maps raw features into the LEVEL-0 channel count.  These coincide
    # for every reference model (CCN_1D asserts nChanels >= its 16-channel
    # floor, ``CCN_1D.h:37``); sizing by channels_at(0) keeps the state
    # allocation and H consistent under any custom channel_schedule.
    params = {"H": uniform_init(next(ki), (cfg.channels_at(0), cfg.feat_dim),
                                dtype),
              "levels": []}
    for l in range(cfg.nLevels):
        C_prev, C = cfg.channels_at(l), cfg.channels_at(l + 1)
        lev = {}
        if cfg.filter == "unrestricted":
            lev["Wf"] = uniform_init(next(ki), (V1, cfg.P, cfg.P), dtype,
                                     fan=cfg.P)
        elif cfg.filter == "unrestricted2":
            lev["Wf1"] = uniform_init(next(ki), (V1, cfg.P, cfg.P), dtype,
                                      fan=cfg.P)
            lev["Wf2"] = uniform_init(next(ki), (V1, cfg.P, cfg.P), dtype,
                                      fan=cfg.P)
        else:
            lev["lambda1"] = uniform_init(next(ki), (V1,), dtype, fan=1)
            lev["lambda2"] = uniform_init(next(ki), (V1,), dtype, fan=1)
        lev["b"] = uniform_init(next(ki), (V1, C), dtype, fan=C)
        if cfg.filter == "theta":
            lev["K"] = uniform_init(next(ki), (2 * C_prev, C), dtype)
        elif cfg.filter == "concat_kk":
            lev["K_eye"] = uniform_init(next(ki), (C_prev, C_prev), dtype)
            lev["K_one"] = uniform_init(next(ki), (C_prev, C_prev), dtype)
        params["levels"].append(lev)
    CL = cfg.channels_at(cfg.nLevels)
    if cfg.nClasses:
        params["W"] = uniform_init(next(ki), (cfg.nClasses, CL), dtype)
    else:
        params["W"] = uniform_init(next(ki), (CL,), dtype)
    return params


def _neighbor_sum(f_prev, vid_prev, adj1, vid_cur, V, P, C):
    """sum_v = SUM_{w in closed 1-hop of v} X[v][w] @ f_w, vectorized.

    f_prev: [V, P, C] previous level states (rows beyond |phi| are zero),
    vid_prev[w, q] = phi_{l-1}(w)[q] (sentinel V), adj1: [V, V] closed 1-hop,
    vid_cur[v, p] = phi_l(v)[p] (sentinel V).
    """
    # Scatter local rows into vertex-id space via one-hot matmul (sentinel V
    # falls outside the iota range -> zero row).  Every operand pair is a
    # 0/1 selection or adjacency: HIGHEST keeps the f32 sums exact where
    # the default precision may round the values to TF32 on the GPU.
    dt = f_prev.dtype
    ein = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)
    selp = (vid_prev[:, :, None] == jnp.arange(V)).astype(dt)   # [V, P, V]
    G = ein("wqu,wqc->wuc", selp, f_prev)                       # [V, V, C]
    M = ein("vw,wuc->vuc", adj1, G)                             # [V, V, C]
    # Gather back into each phi_l(v)'s local ordering (one-hot matmul).
    selc = (vid_cur[:, :, None] == jnp.arange(V)).astype(dt)    # [V, P, V]
    return ein("vpu,vuc->vpc", selc, M)                         # [V, P, C]


def _neighbor_sum_sparse(f_prev, fo_idx, V, P, C):
    """ELL form of :func:`_neighbor_sum`: out[v, p] = SUM_d rows[idx[v,p,d]]
    over the flat [(w q), C] view of the previous level (sentinel V*P reads
    an appended zero row via ell_spmm's weight annihilation)."""
    from graphflow_tpu.ops.sparse import ell_spmm

    rows = f_prev.reshape(V * P, C)
    idx = fo_idx.reshape(V * P, -1)
    w = (idx < V * P).astype(f_prev.dtype)
    return ell_spmm(idx, w, rows).reshape(V, P, C)


def smp1d_states(params, g, cfg: SMP1DConfig):
    """Run the tower, returning per-level matrix states [V, P, C_l]."""
    V, P = g["vmask"].shape[0], cfg.P

    feat = g["wl_feat"]
    if cfg.l1_normalize_features:
        # CCN_1D.h:440-448: feature[v] /= sum_f |feature[v][f]| (guard the
        # all-zero pad rows; real vertices always have nonzero features).
        norm = jnp.abs(feat).sum(axis=-1, keepdims=True)
        feat = feat / jnp.where(norm > 0, norm, 1.0)
    F0 = activations.leaky_relu(feat @ params["H"].T,
                                cfg.tower_alpha)              # [V, C]
    state = jnp.zeros((V, P, cfg.channels_at(0)), F0.dtype).at[:, 0, :].set(
        F0 * g["vmask"][:, None])
    states = [state]
    vid_prev = jnp.full((V, P), V, jnp.int32).at[:, 0].set(
        jnp.arange(V, dtype=jnp.int32))          # phi_0(v) = [v]

    adj1 = jnp.minimum(g["adj"] + jnp.eye(V, dtype=g["adj"].dtype), 1.0)
    adj1 = adj1 * g["vmask"][:, None] * g["vmask"][None, :]

    for l in range(cfg.nLevels):
        lev = params["levels"][l]
        C_prev = cfg.channels_at(l)
        # vid for phi_l: prepared nbr[l-1] holds phi_l(v)[i]; sentinel slots
        # are marked by the row mask.
        vid_cur = g["nbr"][l].astype(jnp.int32)
        rm = g["smask"][l + 1][:, :, 0]                       # [V, P] row mask
        vid_cur = jnp.where(rm > 0, vid_cur, V)

        if cfg.sparse_max_degree is not None and g.get("fo_idx") is not None:
            sum_v = _neighbor_sum_sparse(state, g["fo_idx"][l], V, P, C_prev)
        else:
            sum_v = _neighbor_sum(state, vid_prev, adj1, vid_cur, V, P,
                                  C_prev)
        sum_v = sum_v * rm[:, :, None]

        s = g["sizes"][l + 1]                                  # [V]
        b = lev["b"][s]                                        # [V, C]
        if "lambda1" in lev:
            if cfg.faithful_lambda_grads:
                # lambda -> W_eye [-> W_flat -> W] shared-node chain depth
                # (SMP_1D.h:495-505 vs SMP_theta.h:597-601).
                depth = {"theta": 1, "steerable": 3, "concat": 1,
                         "concat_kk": 1}[cfg.filter]
                l1 = activations.persize_gather_refgrad(
                    lev["lambda1"], s, depth)
                l2 = activations.persize_gather_refgrad(
                    lev["lambda2"], s, depth)
            else:
                l1, l2 = lev["lambda1"][s], lev["lambda2"][s]
        colsum = sum_v.sum(axis=1)                             # [V, C_prev]
        ones_sum = rm[:, :, None] * colsum[:, None, :]         # (1_s @ sum)

        if cfg.filter == "theta":
            a1 = l1[:, None, None] * sum_v
            a2 = l2[:, None, None] * ones_sum
            z = jnp.concatenate([a1, a2], axis=-1) @ lev["K"]
        elif cfg.filter == "steerable":
            z = l1[:, None, None] * sum_v + l2[:, None, None] * ones_sum
        elif cfg.filter == "concat":
            # SMP_1D_ver2.h:521-529: channel-growing concat, no reducer.
            z = jnp.concatenate([l1[:, None, None] * sum_v,
                                 l2[:, None, None] * ones_sum], axis=-1)
        elif cfg.filter == "concat_kk":
            # SMP_1D_ver3.h:542-549: each branch channel-mixed by K before
            # the concat (filtered = affine @ K_eye, filtered2 = affine2 @
            # K_one).
            a1 = (l1[:, None, None] * sum_v) @ lev["K_eye"]
            a2 = (l2[:, None, None] * ones_sum) @ lev["K_one"]
            z = jnp.concatenate([a1, a2], axis=-1)
        elif cfg.filter == "unrestricted":
            Wv = lev["Wf"][s]                                  # [V, P, P]
            Wv = Wv * rm[:, :, None] * rm[:, None, :]
            z = jnp.einsum("vpq,vqc->vpc", Wv, sum_v)
        elif cfg.filter == "unrestricted2":
            # Unrestricted_SMP_1D_ver2.h:102-137: two full spatial filters,
            # outputs concatenated along channels (growth x2).
            m = rm[:, :, None] * rm[:, None, :]
            z1 = jnp.einsum("vpq,vqc->vpc", lev["Wf1"][s] * m, sum_v)
            z2 = jnp.einsum("vpq,vqc->vpc", lev["Wf2"][s] * m, sum_v)
            z = jnp.concatenate([z1, z2], axis=-1)
        else:
            raise ValueError(cfg.filter)

        z = z + b[:, None, :]
        state = activations.leaky_relu(z, cfg.tower_alpha) * rm[:, :, None]
        states.append(state)
        vid_prev = vid_cur
    return states


def _graph_feature(state, vmask):
    """ShrinkMatrix(rows) -> LeakyReLU -> masked vertex sum."""
    vertex = activations.leaky_relu(state.sum(axis=1))         # [V, C]
    return (vertex * vmask[:, None]).sum(axis=0)


def smp1d_level_features(params, g, cfg: SMP1DConfig):
    """Per-level graph features for the pairgraph towers: a LIST of [C_l]
    vectors (channel counts differ per level under a channel schedule)."""
    states = smp1d_states(params, g, cfg)
    return [_graph_feature(s, g["vmask"]) for s in states]


def smp1d_forward(params, g, cfg: SMP1DConfig):
    states = smp1d_states(params, g, cfg)
    graph_feat = _graph_feature(states[-1], g["vmask"])
    if cfg.nClasses:
        return params["W"] @ graph_feat, graph_feat
    return jnp.dot(graph_feat, params["W"]), graph_feat


class SMP1D(GraphModel):
    def __init__(self, cfg: SMP1DConfig, seed: int = 0):
        super().__init__(optimizer=cfg.optimizer)
        self.cfg = cfg
        self.params = init_smp1d_params(jax.random.PRNGKey(seed), cfg)
        if cfg.filter == "unrestricted":
            per_level = ["Wf", "b"]
        elif cfg.filter == "unrestricted2":
            per_level = ["Wf1", "Wf2", "b"]
        else:
            per_level = (["lambda1", "lambda2", "b"]
                         + {"theta": ["K"],
                            "concat_kk": ["K_eye", "K_one"]}.get(cfg.filter,
                                                                 []))
        self.param_order = (["H"]
                            + [f"levels/{l}/{k}" for l in range(cfg.nLevels)
                               for k in per_level]
                            + ["W"])
        self._finish_init()

    def _prepare(self, graph: DenseGraph,
                 pad_nVertices: int = None) -> prep.PreparedGraph:
        return prep.prepare_graph(
            graph, self.cfg.nLevels, pad_nVertices or self.cfg.max_nVertices,
            self.cfg.max_receptive_field, self.cfg.nDepth,
            has_WL_ordering=self.cfg.has_WL_ordering,
            use_wl_features=self.cfg.use_wl_features,
            dtype=np.dtype(self.cfg.dtype),
            fo_degree=self.cfg.sparse_max_degree)

    def _forward(self, params, g):
        return smp1d_forward(params, g, self.cfg)

    def _loss(self, params, g, target):
        out, _ = smp1d_forward(params, g, self.cfg)
        if self.cfg.nClasses:
            return losses.log_loss(out, target.astype(jnp.int32))
        return losses.squared_loss(out, target)


# ----------------------------------------------------------------------
# Named constructors mirroring reference classes
# ----------------------------------------------------------------------

def SMP_theta(max_nVertices, max_receptive_field, nLevels, nChanels,
              nFeatures, nDepth, seed=0) -> SMP1D:
    """``SMP_theta.h``: concat-K filter, receptive-field cap, Adam."""
    return SMP1D(SMP1DConfig(
        max_nVertices=max_nVertices, max_receptive_field=max_receptive_field,
        nLevels=nLevels, nChanels=nChanels, nFeatures=nFeatures,
        nDepth=nDepth, filter="theta", optimizer="adam"), seed)


def SMP_1D(max_nVertices, nLevels, nChanels, nFeatures, nDepth,
           momentum_param=0.9, seed=0) -> SMP1D:
    """``SMP_1D.h``: steerable spatial filter, uncapped phi, Momentum."""
    return SMP1D(SMP1DConfig(
        max_nVertices=max_nVertices, max_receptive_field=None,
        nLevels=nLevels, nChanels=nChanels, nFeatures=nFeatures,
        nDepth=nDepth, filter="steerable", optimizer="momentum"), seed)


def SMP_1D_classification(max_nVertices, nLevels, nChanels, nFeatures,
                          nDepth, nClasses, seed=0) -> SMP1D:
    """``SMP_1D_classification.h``: + Softmax/LogLoss head."""
    return SMP1D(SMP1DConfig(
        max_nVertices=max_nVertices, max_receptive_field=None,
        nLevels=nLevels, nChanels=nChanels, nFeatures=nFeatures,
        nDepth=nDepth, filter="steerable", nClasses=nClasses,
        optimizer="momentum"), seed)


def Unrestricted_SMP_1D(max_nVertices, nLevels, nChanels, nFeatures, nDepth,
                        seed=0) -> SMP1D:
    """``Unrestricted_SMP_1D.h:98-103``: full learned W[size] filters."""
    return SMP1D(SMP1DConfig(
        max_nVertices=max_nVertices, max_receptive_field=None,
        nLevels=nLevels, nChanels=nChanels, nFeatures=nFeatures,
        nDepth=nDepth, filter="unrestricted", optimizer="momentum"), seed)


# CCN_1D (the theta architecture's pair-of-graphs driver, ``CCN_1D.h``)
# lives in graphflow_tpu.models.pairgraphs — the reference model takes
# (molecule_1, molecule_2) pairs, not single graphs.


def SMP_theta_physics(max_nVertices, max_receptive_field, nLevels, nChanels,
                      nFeatures, seed=0):
    """``SMP_theta_physics.h``: raw features only (no WL histograms), no WL
    ranking, and the physics per-level-features MLP head
    (``SMP_theta_physics.h:225-248``) — see models/physics.py."""
    from graphflow_tpu.models.physics import SMPPhysics
    return SMPPhysics(1, max_nVertices, max_receptive_field, nLevels,
                      nChanels, nFeatures, seed=seed)


def SMP_1D_ver2(max_nVertices, nLevels, nChanels, nFeatures, nDepth,
                momentum_param=0.9, seed=0) -> SMP1D:
    """``SMP_1D_ver2.h:131-166``: channel-growing concat of the two scalar
    steerable branches (C_l = 2 C_{l-1}, no reducer), uncapped phi,
    Momentum; tower activations are PLAIN ReLU (alpha=0,
    ``SMP_1D_ver2.h:491,534``)."""
    return SMP1D(SMP1DConfig(
        max_nVertices=max_nVertices, max_receptive_field=None,
        nLevels=nLevels, nChanels=nChanels, nFeatures=nFeatures,
        nDepth=nDepth, filter="concat", tower_alpha=0.0,
        optimizer="momentum"), seed)


def SMP_1D_ver3(max_nVertices, nLevels, nChanels, nFeatures, nDepth,
                momentum_param=0.9, seed=0) -> SMP1D:
    """``SMP_1D_ver3.h:142-175,542-549``: ver2 plus per-level K_eye/K_one
    (prevC x prevC) channel mixers applied to each branch before the
    concat; ReLU towers like ver2 (``SMP_1D_ver3.h:506,555``)."""
    return SMP1D(SMP1DConfig(
        max_nVertices=max_nVertices, max_receptive_field=None,
        nLevels=nLevels, nChanels=nChanels, nFeatures=nFeatures,
        nDepth=nDepth, filter="concat_kk", tower_alpha=0.0,
        optimizer="momentum"), seed)


def SMP_1D_ver3_classification(max_nVertices, nLevels, nChanels, nFeatures,
                               nDepth, nClasses, seed=0) -> SMP1D:
    """``SMP_1D_ver3_classification.h``."""
    return SMP1D(SMP1DConfig(
        max_nVertices=max_nVertices, max_receptive_field=None,
        nLevels=nLevels, nChanels=nChanels, nFeatures=nFeatures,
        nDepth=nDepth, filter="concat_kk", tower_alpha=0.0,
        nClasses=nClasses, optimizer="momentum"), seed)


def Unrestricted_SMP_1D_ver2(max_nVertices, nLevels, nChanels, nFeatures,
                             nDepth, seed=0) -> SMP1D:
    """``Unrestricted_SMP_1D_ver2.h:102-137``: TWO full W[size] spatial
    filters per size, outputs concatenated (channel growth x2/level);
    ReLU towers (``Unrestricted_SMP_1D_ver2.h:458,498``)."""
    return SMP1D(SMP1DConfig(
        max_nVertices=max_nVertices, max_receptive_field=None,
        nLevels=nLevels, nChanels=nChanels, nFeatures=nFeatures,
        nDepth=nDepth, filter="unrestricted2", tower_alpha=0.0,
        optimizer="momentum"), seed)


def smp1d_inspect(model, graph) -> dict:
    """Activation dump for debugging (ForDebugging-style, mirroring
    ``smp2d.smp2d_inspect``): per-level matrix states, vertex features and
    the graph feature as NumPy arrays restricted to real vertices."""
    import numpy as np

    batch = model._stack([graph])
    g = jax.tree_util.tree_map(lambda x: x[0], batch)
    states = smp1d_states(model.params, g, model.cfg)
    n = graph.nVertices
    vertex = activations.leaky_relu(states[-1].sum(axis=1))
    return {
        "states": [np.asarray(s)[:n] for s in states],
        "vertex_features": np.asarray(vertex)[:n],
        "graph_feature": np.asarray(_graph_feature(states[-1],
                                                   g["vmask"])),
    }
