"""Second-order Steerable Message Passing (the CCN flagship family).

One config-driven module covering the reference's second-order SMP models:

  SMP_omega          (``SMP_omega.h``)  — contraction 18, receptive-field cap
  SMP_beta           (``SMP_beta.h``)   — contraction 18, no cap
  SMP_gamma          (``SMP_gamma.h``)  — contraction 4
  SMP_2D_ver6        (``SMP_2D_ver6.h``)— contraction 10
  SMP_2D_ver7        (``SMP_2D_ver7.h``)— contraction 50
  SMP_2D_ver8        (``SMP_2D_ver8.h``)— contraction 18 (Momentum)
  *_physics          (``SMP_omega_physics.h``) — raw features, Coulomb adj
  *_classification   — LogLoss head over class scores

Math per level (reference ``SMP_omega.h:607-692``):
  level 0:  F_v = LeakyReLU(H @ wl_feat_v)            as a 1x1xC tensor
  level l:  for each w in phi_l(v): gather X f_w X^T  (permutation alignment)
            T = stack of gathered tensors; Y = RisiContraction_k(T, radj)
            Z = reshape(Y) @ K_l + b_l;  F = LeakyReLU(Z)  (s x s x C)
  head:     vertex = LeakyReLU(sum_{p1,p2} F);  graph = sum_v vertex
            predict = <graph, W>;  loss = 0.5 (predict - target)^2

Re-design: the per-(v,w) permutation matmuls X f X^T become one flat
gather with a zero sentinel (see ``graphflow_tpu.core.prep``), every
vertex is processed in one vmapped contraction bank call, and the whole
per-molecule "graph rebuild" is a trace-once jitted function over padded
arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from graphflow_tpu.core import prep
from graphflow_tpu.core.graph import DenseGraph
from graphflow_tpu.models.base import GraphModel
from graphflow_tpu.ops import activations, contractions, losses


_CONTRACTIONS = {
    4: (contractions.risi_contraction_4, 4),
    10: (contractions.risi_contraction_10, 10),
    18: (contractions.risi_contraction_18, 18),
    50: (contractions.risi_contraction_50, 50),
}


@dataclasses.dataclass
class SMP2DConfig:
    max_nVertices: int
    max_receptive_field: Optional[int]
    nLevels: int
    nChanels: int
    nFeatures: int
    nDepth: int
    has_WL_ordering: bool = True
    use_coulomb: bool = False
    use_wl_features: bool = True      # False => physics variants
    contraction: int = 18             # 4 | 10 | 18 | 50
    nClasses: Optional[int] = None    # set => classification head (LogLoss)
    optimizer: str = "adam"
    dtype: str = "float32"
    # Explicit per-level channel counts (length nLevels+1).  The pairgraph
    # towers HALVE channels each level (``SMP_omega_pairgraphs.h:202-204``:
    # C_l = max(C_{l-1}/2, 1)); None = constant nChanels.
    channel_schedule: Optional[Tuple[int, ...]] = None

    @property
    def feat_dim(self) -> int:
        return (self.nFeatures * (self.nDepth + 1)
                if self.use_wl_features else self.nFeatures)

    @property
    def P(self) -> int:
        return (self.max_receptive_field
                if self.max_receptive_field is not None else self.max_nVertices)

    def channels_at(self, l: int) -> int:
        if self.channel_schedule is not None:
            return self.channel_schedule[l]
        return self.nChanels


def init_smp2d_params(key, cfg: SMP2DConfig):
    """Parameters in the reference's registration order
    (``SMP_omega.h:289-295``): H, then per level (K, b), then W."""
    from graphflow_tpu.optim.utils import uniform_init

    nCon = _CONTRACTIONS[cfg.contraction][1]
    dtype = jnp.dtype(cfg.dtype)
    keys = jax.random.split(key, 2 + 2 * cfg.nLevels)
    params = {
        "H": uniform_init(keys[0], (cfg.channels_at(0), cfg.feat_dim),
                          dtype),
        "levels": [
            {"K": uniform_init(keys[1 + 2 * l],
                               (nCon * cfg.channels_at(l),
                                cfg.channels_at(l + 1)), dtype),
             "b": uniform_init(keys[2 + 2 * l], (cfg.channels_at(l + 1),),
                               dtype)}
            for l in range(cfg.nLevels)
        ],
    }
    CL = cfg.channels_at(cfg.nLevels)
    if cfg.nClasses:
        params["W"] = uniform_init(keys[-1], (cfg.nClasses, CL), dtype)
    else:
        params["W"] = uniform_init(keys[-1], (CL,), dtype)
    return params


def _gather_neighbor_tensors(state_pad, nbr, pos):
    """The per-(v, w) permutation matmuls X f_w X^T as one gather
    (reference ``SMP_omega.h:641-648``).

    state_pad: [Vsrc, P+1, P+1, C] spatially zero-padded previous level,
    nbr: [V, P] neighbor ids (sentinel Vsrc), pos: [V, P, P] position
    maps (sentinel P).  Returns T: [V, P, P, P, C]:
    T[v, i, p1, p2] = f_{w_i}[pos[v,i,p1], pos[v,i,p2]] with absent
    vertices/slots contributing exact zeros.

    state_pad may have MORE rows than nbr (the partitioned path gathers
    from a halo-extended buffer); the output vertex axis is nbr's.  The
    neighbor id and both positions fold into one row index over the flat
    [(Vsrc+1)(P+1)(P+1), C] view, whose appended zero vertex serves the
    sentinel id Vsrc.  A gather copies values, so T is bit-exact in every
    dtype and at every matmul precision; its adjoint is XLA's scatter-add.
    """
    Vsrc, Q, C = state_pad.shape[0], state_pad.shape[1], state_pad.shape[3]
    V, P = nbr.shape
    src = jnp.pad(state_pad, ((0, 1), (0, 0), (0, 0), (0, 0))).reshape(
        (Vsrc + 1) * Q * Q, C)
    rows = ((nbr[:, :, None, None] * Q + pos[:, :, :, None]) * Q
            + pos[:, :, None, :])                               # [V,P,P,P]
    return src.at[rows.reshape(-1)].get(mode="promise_in_bounds").reshape(
        V, P, P, P, C)


def smp2d_level(cfg: SMP2DConfig, state, nbr, pos, radj, K, b,
                case_mask=None):
    """One level from the previous one: neighbor gather + contraction bank
    + channel matmul + bias + LeakyReLU.  state [Vsrc, P, P, C] (Vsrc may
    exceed V, see _gather_neighbor_tensors), nbr [V, P], pos/radj
    [V, P, P] -> [V, P, P, Cout] (before the level's smask).

    The 10- and 50-case banks use their fused bank + K forms, which never
    build the [V, P, P, nCon*C] concat (risi_contraction_{10,50}_matmul);
    the others run the case bank and then ONE flattened [V*P*P, nCon*C]
    matmul, which XLA hands to the BLAS library."""
    contract_fn, nCon = _CONTRACTIONS[cfg.contraction]
    V, P, C, Cout = nbr.shape[0], nbr.shape[1], state.shape[-1], K.shape[1]
    with jax.named_scope("gather"):
        state_pad = jnp.pad(state, ((0, 0), (0, 1), (0, 1), (0, 0)))
        T = _gather_neighbor_tensors(state_pad, nbr, pos)
    if cfg.contraction in (10, 50) and case_mask is None:
        fused_bank = (contractions.risi_contraction_50_matmul
                      if cfg.contraction == 50
                      else contractions.risi_contraction_10_matmul)
        with jax.named_scope("bank"):
            Z = fused_bank(T, radj, K).reshape(V, P * P, Cout)
    else:
        with jax.named_scope("bank"):
            Y = (jax.vmap(contract_fn)(T) if cfg.contraction == 4
                 else jax.vmap(contract_fn)(T, radj))     # [V,P,P,nCon*C]
            if case_mask is not None:
                Y = Y * jnp.repeat(case_mask, C)[None, None, None, :]
        with jax.named_scope("channel_matmul"):
            Z = (Y.reshape(V * P * P, nCon * C) @ K).reshape(V, P * P, Cout)
    return activations.leaky_relu(Z + b[None, None, :]).reshape(
        V, P, P, Cout)


def smp2d_states(params, g, cfg: SMP2DConfig, case_mask=None):
    """Run the tower, returning the per-level vertex tensor states
    (list of [V, P, P, C], levels 0..nLevels).

    ``case_mask`` ([nContractions] multiplier) enables the sigma variant's
    per-case contraction dropout (RisiContraction_18_dropout.h)."""
    # V from the data (shape-polymorphic for bucketed batching); P/C static.
    V, P, C = g["vmask"].shape[0], cfg.P, cfg.channels_at(0)

    # Level 0 (reference SMP_omega.h:616-627): 1x1xC vertex tensors.
    F0 = activations.leaky_relu(g["wl_feat"] @ params["H"].T)   # [V, C]
    state = jnp.zeros((V, P, P, C), F0.dtype).at[:, 0, 0, :].set(
        F0 * g["vmask"][:, None])
    states = [state]

    for l in range(cfg.nLevels):
        lv = params["levels"][l]
        state = smp2d_level(cfg, state, g["nbr"][l], g["pos"][l],
                            g["radj"][l], lv["K"], lv["b"], case_mask)
        state = state * g["smask"][l + 1][:, :, :, None]
        states.append(state)
    return states


def _graph_feature(state, vmask):
    """Shrink -> LeakyReLU -> masked vertex sum (SMP_omega.h:674-686)."""
    vertex = activations.leaky_relu(state.sum(axis=(1, 2)))     # [V, C]
    return (vertex * vmask[:, None]).sum(axis=0)                # [C]


def smp2d_level_features(params, g, cfg: SMP2DConfig, case_mask=None):
    """Per-level graph features (the pairgraph towers collect these at every
    level, SMP_omega_pairgraphs.h:640-654).  Returns a LIST of [C_l]
    vectors — channel counts differ per level under a channel schedule."""
    states = smp2d_states(params, g, cfg, case_mask=case_mask)
    return [_graph_feature(s, g["vmask"]) for s in states]


def smp2d_forward(params, g, cfg: SMP2DConfig):
    """Pure forward for one prepared graph. Returns (prediction, graph_feat).

    ``g`` is one element of a stacked GraphBatch (dict of arrays without the
    batch axis).
    """
    states = smp2d_states(params, g, cfg)
    graph_feat = _graph_feature(states[-1], g["vmask"])
    if cfg.nClasses:
        scores = params["W"] @ graph_feat                       # [nClasses]
        return scores, graph_feat
    predict = jnp.dot(graph_feat, params["W"])
    return predict, graph_feat


class SMP2D(GraphModel):
    """Config-driven second-order SMP model with the reference API."""

    def __init__(self, cfg: SMP2DConfig, seed: int = 0):
        super().__init__(optimizer=cfg.optimizer)
        self.cfg = cfg
        self.params = init_smp2d_params(jax.random.PRNGKey(seed), cfg)
        self.param_order = (["H"]
                            + [f"levels/{l}/{k}" for l in range(cfg.nLevels)
                               for k in ("K", "b")]
                            + ["W"])
        self._finish_init()

    def _prepare(self, graph: DenseGraph,
                 pad_nVertices: int = None) -> prep.PreparedGraph:
        return prep.prepare_graph(
            graph, self.cfg.nLevels, pad_nVertices or self.cfg.max_nVertices,
            self.cfg.max_receptive_field, self.cfg.nDepth,
            has_WL_ordering=self.cfg.has_WL_ordering,
            use_coulomb=self.cfg.use_coulomb,
            use_wl_features=self.cfg.use_wl_features,
            dtype=np.dtype(self.cfg.dtype),
        )

    def _forward(self, params, g):
        return smp2d_forward(params, g, self.cfg)

    def _loss(self, params, g, target):
        out, _ = smp2d_forward(params, g, self.cfg)
        if self.cfg.nClasses:
            return losses.log_loss(out, target.astype(jnp.int32))
        return losses.squared_loss(out, target)


# ----------------------------------------------------------------------
# Named constructors mirroring the reference model classes
# ----------------------------------------------------------------------

def SMP_omega(max_nVertices, max_receptive_field, nLevels, nChanels,
              nFeatures, nDepth, has_WL_ordering=True, use_coulomb=False,
              seed=0) -> SMP2D:
    """``SMP_omega.h:31-113``: contraction 18 + receptive-field cap + Adam."""
    return SMP2D(SMP2DConfig(
        max_nVertices=max_nVertices, max_receptive_field=max_receptive_field,
        nLevels=nLevels, nChanels=nChanels, nFeatures=nFeatures,
        nDepth=nDepth, has_WL_ordering=has_WL_ordering,
        use_coulomb=use_coulomb, contraction=18, optimizer="adam"), seed)


def SMP_beta(max_nVertices, nLevels, nChanels, nFeatures, nDepth,
             use_coulomb=False, seed=0) -> SMP2D:
    """``SMP_beta.h``: omega without the receptive-field cap
    (``SMP_beta.h:199-208``)."""
    return SMP2D(SMP2DConfig(
        max_nVertices=max_nVertices, max_receptive_field=None,
        nLevels=nLevels, nChanels=nChanels, nFeatures=nFeatures,
        nDepth=nDepth, use_coulomb=use_coulomb, contraction=18,
        optimizer="adam"), seed)


def SMP_gamma(max_nVertices, max_receptive_field, nLevels, nChanels,
              nFeatures, nDepth, seed=0) -> SMP2D:
    """``SMP_gamma.h:199-207``: the RisiContraction_4 variant."""
    return SMP2D(SMP2DConfig(
        max_nVertices=max_nVertices, max_receptive_field=max_receptive_field,
        nLevels=nLevels, nChanels=nChanels, nFeatures=nFeatures,
        nDepth=nDepth, contraction=4, optimizer="adam"), seed)


# The *_physics variants (raw features, optional Coulomb adjacency, and a
# DIFFERENT per-level-features MLP head, ``SMP_omega_physics.h:211-239``)
# live in graphflow_tpu.models.physics; re-exported here for the reference
# API surface.
from graphflow_tpu.models.physics import (          # noqa: E402,F401
    SMP_omega_physics, SMP_beta_physics, SMP_gamma_physics)


def SMP_2D_ver6(max_nVertices, max_receptive_field, nLevels, nChanels,
                nFeatures, nDepth, seed=0) -> SMP2D:
    """``SMP_2D_ver6.h:134-141``: RisiContraction_10 + K(10C->C)."""
    return SMP2D(SMP2DConfig(
        max_nVertices=max_nVertices, max_receptive_field=max_receptive_field,
        nLevels=nLevels, nChanels=nChanels, nFeatures=nFeatures,
        nDepth=nDepth, contraction=10, optimizer="momentum"), seed)


def SMP_2D_ver7(max_nVertices, max_receptive_field, nLevels, nChanels,
                nFeatures, nDepth, seed=0) -> SMP2D:
    """``SMP_2D_ver7.h:134-141``: RisiContraction_50 + K(50C->C)."""
    return SMP2D(SMP2DConfig(
        max_nVertices=max_nVertices, max_receptive_field=max_receptive_field,
        nLevels=nLevels, nChanels=nChanels, nFeatures=nFeatures,
        nDepth=nDepth, contraction=50, optimizer="momentum"), seed)


def SMP_2D_ver8(max_nVertices, max_receptive_field, nLevels, nChanels,
                nFeatures, nDepth, seed=0) -> SMP2D:
    """``SMP_2D_ver8.h:134-141``: RisiContraction_18 + K(18C->C),
    Momentum optimizer."""
    return SMP2D(SMP2DConfig(
        max_nVertices=max_nVertices, max_receptive_field=max_receptive_field,
        nLevels=nLevels, nChanels=nChanels, nFeatures=nFeatures,
        nDepth=nDepth, contraction=18, optimizer="momentum"), seed)

def SMP_2D_ver6_classification(max_nVertices, max_receptive_field, nLevels,
                               nChanels, nFeatures, nDepth, nClasses, seed=0):
    """``SMP_2D_ver6_classification.h``."""
    return SMP2D(SMP2DConfig(
        max_nVertices=max_nVertices, max_receptive_field=max_receptive_field,
        nLevels=nLevels, nChanels=nChanels, nFeatures=nFeatures,
        nDepth=nDepth, contraction=10, nClasses=nClasses,
        optimizer="momentum"), seed)


def SMP_2D_ver7_classification(max_nVertices, max_receptive_field, nLevels,
                               nChanels, nFeatures, nDepth, nClasses, seed=0):
    """``SMP_2D_ver7_classification.h``."""
    return SMP2D(SMP2DConfig(
        max_nVertices=max_nVertices, max_receptive_field=max_receptive_field,
        nLevels=nLevels, nChanels=nChanels, nFeatures=nFeatures,
        nDepth=nDepth, contraction=50, nClasses=nClasses,
        optimizer="momentum"), seed)


def SMP_2D_ver8_thread(max_nVertices, max_receptive_field, nLevels, nChanels,
                       nFeatures, nDepth, nThreads=None, seed=0):
    """``SMP_2D_ver8_thread.h``: the threaded-contraction variant.  The
    6-way std::thread job split (RisiContraction_18_thread.h:745-781) is
    subsumed by XLA's parallel execution; identical math to ver8."""
    return SMP_2D_ver8(max_nVertices, max_receptive_field, nLevels, nChanels,
                       nFeatures, nDepth, seed)


def smp2d_inspect(model, graph) -> dict:
    """Activation dump for debugging (the reference's ``ForDebugging()``,
    ``SMP_2D.h:762-795`` prints per-level activations): returns per-level
    vertex tensor states, vertex features, and the graph feature as NumPy
    arrays restricted to real vertices."""
    import numpy as np

    batch = model._stack([graph])
    g = jax.tree_util.tree_map(lambda x: x[0], batch)
    states = smp2d_states(model.params, g, model.cfg)
    n = graph.nVertices
    vertex = activations.leaky_relu(states[-1].sum(axis=(1, 2)))
    return {
        "states": [np.asarray(s)[:n] for s in states],
        "vertex_features": np.asarray(vertex)[:n],
        "graph_feature": np.asarray(_graph_feature(states[-1], g["vmask"])),
    }


# ----------------------------------------------------------------------
# GPU model drivers (reference GraphFlow_gpu/): here the whole model IS
# the accelerated path — one XLA program covers what the reference split
# into CPU orchestration + per-op CUDA kernels + per-replica streams.
# These aliases keep the reference class names resolvable.
# ----------------------------------------------------------------------

def SMP_omega_gpu(*args, **kwargs):
    """``GraphFlow_gpu/SMP_omega_gpu.h``: omega with RisiContraction_18_gpu
    nodes.  The equivalent is SMP_omega itself (the contraction bank is
    compiled for the accelerator; no per-op offload exists)."""
    return SMP_omega(*args, **kwargs)


def SMP_beta_gpu(*args, **kwargs):
    """``GraphFlow_gpu/SMP_beta_gpu.h``: see SMP_omega_gpu."""
    return SMP_beta(*args, **kwargs)


def SMP_omega_gpu_multistreams(*args, nThreads=None, **kwargs):
    """``GraphFlow_gpu/SMP_omega_gpu_multistreams.h``: replica-per-stream
    batch concurrency.  Here batch concurrency is the vmapped batch axis
    of one jitted program (XLA schedules it); multi-device concurrency is
    graphflow_tpu.parallel."""
    return SMP_omega(*args, **kwargs)


def SMP_beta_gpu_multistreams(*args, nThreads=None, **kwargs):
    """``GraphFlow_gpu/SMP_beta_gpu_multistreams.h``: see above."""
    return SMP_beta(*args, **kwargs)
