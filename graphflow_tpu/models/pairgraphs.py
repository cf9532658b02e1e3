"""Two-tower Siamese models over graph pairs (graph similarity / kernels).

Covers the reference models:

  SMP_{beta,gamma,omega,sigma}_pairgraphs (``SMP_omega_pairgraphs.h``):
      two SEPARATE second-order towers (own H/K/b per tower,
      ``SMP_omega_pairgraphs.h:680-692``), per-level graph features collected
      at EVERY level (``:640-654``), concatenated interleaved
      [t1[0], t2[0], t1[1], t2[1], ...]... — reference order is all levels of
      tower 1's feature then tower 2's per level pair (``:705-709``:
      for l: add level_feature_1[l]; add level_feature_2[l]) — then a 2-layer
      LeakyReLU MLP head with nHidden_1 = max(total/2, 10),
      nHidden_2 = max(nHidden_1/2, 10) (``:332-333``) and a linear output.
      Towers use RAW features (no WL histograms, ``:155``) and insertion-order
      receptive fields (no WL ranking pass in ``complete_computation_graph``).
      sigma = omega towers + contraction-case dropout
      (``SMP_sigma_pairgraphs.h:248-257``).
  SMP_theta_pairgraphs: first-order towers, same head.
  GCN_{1,2,3}D_Kernel (``GCN_1D_Kernel.h:240-289``): two towers with SHARED
      parameters, top-level features only, ConCat + InnerProduct head.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from graphflow_tpu.core import batching, prep
from graphflow_tpu.core.graph import DenseGraph
from graphflow_tpu.models.base import GraphModel
from graphflow_tpu.models.smp2d import (
    SMP2DConfig, init_smp2d_params, smp2d_level_features)
from graphflow_tpu.models.smp1d import (
    SMP1DConfig, init_smp1d_params, smp1d_level_features)
from graphflow_tpu.models.gcn import GCNConfig, init_gcn_params, gcn_forward
from graphflow_tpu.ops import activations, losses
from graphflow_tpu import optim as optim_lib
from graphflow_tpu.utils import checkpoint as ckpt


class PairGraphModel:
    """Shared machinery for models taking (graph_1, graph_2, target)."""

    def __init__(self, optimizer="adam", **opt_kwargs):
        self.opt = optim_lib.make_optimizer(optimizer, **opt_kwargs)
        # graph -> {tower index: PreparedGraph}; weak-keyed so a collected
        # DenseGraph can never alias a newly-allocated one (see
        # GraphModel._prep_cache).
        self._prep_cache = weakref.WeakKeyDictionary()
        self.dropout_nKept = None
        self.param_order = None

    def _finish_init(self):
        # Reference-exact per-element Adam beta_t schedule (see
        # optim.adam / GraphModel._finish_init).
        if (self.param_order is not None
                and self.opt.set_element_schedule is not None):
            self.opt.set_element_schedule(self.params, self.param_order)
        self.opt_state = self.opt.init(self.params)

        def batch_loss(params, batch):
            mask = batch.get("case_mask")
            losses_ = jax.vmap(
                lambda g1, g2, t: self._loss(params, g1, g2, t,
                                             case_mask=mask))(
                    batch["g1"], batch["g2"], batch["target"])
            return losses_.sum()

        self._batch_loss = jax.jit(batch_loss)
        self._batch_grad = jax.jit(jax.value_and_grad(batch_loss))
        self._jit_forward = jax.jit(
            lambda params, batch: jax.vmap(
                lambda g1, g2: self._forward(params, g1, g2))(
                    batch["g1"], batch["g2"]))

    def _prepare_1(self, graph):
        raise NotImplementedError

    def _prepare_2(self, graph):
        raise NotImplementedError

    def _stack(self, graphs1, graphs2, targets=None):
        def cached(graph, which, fn):
            per = self._prep_cache.get(graph)
            if per is None:
                per = self._prep_cache.setdefault(graph, {})
            if which not in per:
                per[which] = fn(graph)
            return per[which]

        b1 = batching.stack_graphs(
            [cached(g, 1, self._prepare_1) for g in graphs1])
        b2 = batching.stack_graphs(
            [cached(g, 2, self._prepare_2) for g in graphs2])
        batch = {"g1": b1, "g2": b2}
        if targets is not None:
            batch["target"] = jnp.asarray(np.asarray(targets, np.float32))
        return batch

    # Reference API (SMP_omega_pairgraphs.h getLoss/BatchLearn/Predict)
    def getLoss(self, graphs1, graphs2, targets) -> float:
        batch = self._stack(graphs1, graphs2, targets)
        if getattr(self, "dropout_nKept", None):
            from graphflow_tpu.ops.contractions import dropout_case_mask
            batch["case_mask"] = dropout_case_mask(
                jax.random.PRNGKey(0), self.dropout_nKept, train=False)
        return float(self._batch_loss(self.params, batch))

    def BatchLearn(self, graphs1, graphs2, targets, learning_rate):
        batch = self._stack(graphs1, graphs2, targets)
        if getattr(self, "dropout_nKept", None):
            from graphflow_tpu.ops.contractions import dropout_case_mask
            self._dropout_key, sub = jax.random.split(self._dropout_key)
            batch["case_mask"] = dropout_case_mask(
                sub, self.dropout_nKept, train=True)
        loss_before, grads = self._batch_grad(self.params, batch)
        self.params, self.opt_state = self.opt.update(
            self.params, self.opt_state, grads, learning_rate,
            nBatch=len(graphs1))
        return float(loss_before), float(self._batch_loss(self.params, batch))

    Threaded_BatchLearn = BatchLearn

    def Predict(self, graph1, graph2) -> float:
        pred = self._jit_forward(self.params, self._stack([graph1], [graph2]))
        return float(np.asarray(pred)[0])

    def save_model(self, filename):
        ckpt.save_text(filename, self.params, self.param_order)

    def load_model(self, filename):
        self.params = ckpt.load_text(filename, self.params,
                                     self.param_order)
        self.opt_state = self.opt.init(self.params)


def _mlp_head_dims(nTotal: int):
    """Reference SMP_omega_pairgraphs.h:332-333."""
    h1 = max(nTotal // 2, 10)
    h2 = max(h1 // 2, 10)
    return h1, h2


class SMPPairGraphs(PairGraphModel):
    """Second- or first-order Siamese SMP over graph pairs."""

    def __init__(self, order: int, max_nVertices_1: int, max_nVertices_2: int,
                 max_receptive_field: int, nLevels: int, nChanels: int,
                 nFeatures_1: int, nFeatures_2: int, use_coulomb=False,
                 contraction: int = 18, dropout_nKept: Optional[int] = None,
                 channel_schedule: Optional[tuple] = None,
                 head_dims: Optional[tuple] = None,
                 l1_normalize_features: bool = False, seed: int = 0):
        super().__init__(optimizer="adam")
        # Every reference pairgraphs tower HALVES the channel count per
        # level: C_l = max(C_{l-1} / 2, 1)
        # (``SMP_omega_pairgraphs.h:202-204``, ``SMP_theta_pairgraphs.h:
        # 210-212`` — uncovered by the binary-parity harness in round 4:
        # the towers converged fine with constant channels, but the
        # activations could not match).  ``channel_schedule`` overrides
        # (CCN_1D's decay=1.0 keeps channels constant).
        if channel_schedule is None:
            schedule = [nChanels]
            for _ in range(nLevels):
                schedule.append(max(schedule[-1] // 2, 1))
            schedule = tuple(schedule)
        else:
            schedule = tuple(channel_schedule)
        mk_cfg = lambda V, F: (SMP2DConfig if order == 2 else SMP1DConfig)(
            max_nVertices=V, max_receptive_field=max_receptive_field,
            nLevels=nLevels, nChanels=nChanels, nFeatures=F, nDepth=0,
            has_WL_ordering=False, use_wl_features=False,
            channel_schedule=schedule,
            **({"use_coulomb": use_coulomb, "contraction": contraction}
               if order == 2 else
               {"l1_normalize_features": l1_normalize_features}))
        self.order = order
        self.cfg1 = mk_cfg(max_nVertices_1, nFeatures_1)
        self.cfg2 = mk_cfg(max_nVertices_2, nFeatures_2)
        self.dropout_nKept = dropout_nKept
        self._dropout_key = jax.random.PRNGKey(1234 + seed)

        # nTotalFeatures = sum over levels of both towers' channel counts
        # (SMP_omega_pairgraphs.h:323-328).
        nTotal = 2 * sum(schedule)
        # CCN_1D sizes the head by the same ceil-decay rule as the tower
        # (``CCN_1D.h:352-353``); the SMP pairgraph heads use max(n/2, 10)
        # (``SMP_omega_pairgraphs.h:332-333``).
        h1, h2 = head_dims if head_dims is not None else _mlp_head_dims(nTotal)
        self.head_dims = (h1, h2)
        from graphflow_tpu.optim.utils import uniform_init
        init_fn = init_smp2d_params if order == 2 else init_smp1d_params
        keys = jax.random.split(jax.random.PRNGKey(seed), 5)
        t1 = init_fn(keys[0], self.cfg1)
        t2 = init_fn(keys[1], self.cfg2)
        t1.pop("W"), t2.pop("W")  # towers have no regression head
        self.params = {
            "tower1": t1, "tower2": t2,
            "W1": uniform_init(keys[2], (h1, nTotal), jnp.float32),
            "W2": uniform_init(keys[3], (h2, h1), jnp.float32),
            "W3": uniform_init(keys[4], (h2,), jnp.float32),
        }
        # Registration order (SMP_omega_pairgraphs.h:393-406).  The
        # first-order towers' per-size lambda/b interleave is approximated
        # by whole arrays (affects the text-checkpoint layout and the
        # per-element Adam offsets within a level block only).
        if order == 2:
            per_level = ["K", "b"]
        else:
            per_level = ["lambda1", "lambda2", "b", "K"]
        self.param_order = (
            ["tower1/H", "tower2/H"]
            + [f"tower{t}/levels/{l}/{k}" for l in range(nLevels)
               for t in (1, 2) for k in per_level]
            + ["W1", "W2", "W3"])
        self._finish_init()

    def _prepare_cfg(self, graph, cfg):
        kwargs = dict(has_WL_ordering=False, use_wl_features=False)
        if self.order == 2:
            kwargs["use_coulomb"] = cfg.use_coulomb
        return prep.prepare_graph(graph, cfg.nLevels, cfg.max_nVertices,
                                  cfg.max_receptive_field, cfg.nDepth,
                                  **kwargs)

    def _prepare_1(self, graph):
        return self._prepare_cfg(graph, self.cfg1)

    def _prepare_2(self, graph):
        return self._prepare_cfg(graph, self.cfg2)

    def _forward(self, params, g1, g2, case_mask=None):
        if self.order == 2:
            feats_fn = lambda p, g, c: smp2d_level_features(
                p, g, c, case_mask=case_mask)
        else:
            feats_fn = smp1d_level_features
        f1 = feats_fn(params["tower1"], g1, self.cfg1)  # list of [C_l]
        f2 = feats_fn(params["tower2"], g2, self.cfg2)
        # Reference concat order: for each level, tower1[l] then tower2[l]
        # (SMP_omega_pairgraphs.h:703-708); widths shrink with the level.
        merged = jnp.concatenate(
            [x for pair in zip(f1, f2) for x in pair])
        h = activations.leaky_relu(params["W1"] @ merged)
        h = activations.leaky_relu(params["W2"] @ h)
        return jnp.dot(h, params["W3"])

    def _loss(self, params, g1, g2, target, case_mask=None):
        return losses.squared_loss(
            self._forward(params, g1, g2, case_mask=case_mask), target)


def SMP_omega_pairgraphs(max_nVertices_1, max_nVertices_2,
                         max_receptive_field, nLevels, nChanels, nFeatures_1,
                         nFeatures_2, use_coulomb=False, seed=0):
    """``SMP_omega_pairgraphs.h:81-128``."""
    return SMPPairGraphs(2, max_nVertices_1, max_nVertices_2,
                         max_receptive_field, nLevels, nChanels, nFeatures_1,
                         nFeatures_2, use_coulomb=use_coulomb, seed=seed)


def SMP_beta_pairgraphs(max_nVertices_1, max_nVertices_2, nLevels, nChanels,
                        nFeatures_1, nFeatures_2, seed=0):
    """``SMP_beta_pairgraphs.h``: uncapped receptive fields."""
    return SMPPairGraphs(2, max_nVertices_1, max_nVertices_2,
                         max(max_nVertices_1, max_nVertices_2), nLevels,
                         nChanels, nFeatures_1, nFeatures_2, seed=seed)


def SMP_gamma_pairgraphs(max_nVertices_1, max_nVertices_2,
                         max_receptive_field, nLevels, nChanels, nFeatures_1,
                         nFeatures_2, seed=0):
    """``SMP_gamma_pairgraphs.h``: RisiContraction_4 towers."""
    return SMPPairGraphs(2, max_nVertices_1, max_nVertices_2,
                         max_receptive_field, nLevels, nChanels, nFeatures_1,
                         nFeatures_2, contraction=4, seed=seed)


def SMP_sigma_pairgraphs(max_nVertices_1, max_nVertices_2,
                         max_receptive_field, nLevels, nChanels, nFeatures_1,
                         nFeatures_2, nKept=9, seed=0):
    """``SMP_sigma_pairgraphs.h:248-257``: omega towers + per-case
    contraction dropout.  The stochastic per-step case mask is available via
    ``ops.contractions.risi_contraction_18_dropout``; this constructor
    draws a fresh random nKept-case mask per BatchLearn step and applies the
    nKept/18 eval scaling in getLoss (DropOut-style, non-inverted)."""
    return SMPPairGraphs(2, max_nVertices_1, max_nVertices_2,
                         max_receptive_field, nLevels, nChanels, nFeatures_1,
                         nFeatures_2, dropout_nKept=nKept, seed=seed)


def SMP_theta_pairgraphs(max_nVertices_1, max_nVertices_2,
                         max_receptive_field, nLevels, nChanels, nFeatures_1,
                         nFeatures_2, seed=0):
    """``SMP_theta_pairgraphs.h``: first-order towers."""
    return SMPPairGraphs(1, max_nVertices_1, max_nVertices_2,
                         max_receptive_field, nLevels, nChanels, nFeatures_1,
                         nFeatures_2, seed=seed)


def CCN_1D(max_nVertices_1, max_nVertices_2, max_receptive_field, nLevels,
           nChanels, nFeatures_1, nFeatures_2, nChanels_decay=1.0, seed=0):
    """``CCN_1D.h:34-57``: the pair-of-graphs CCN — two first-order towers
    with per-level features and an MLP similarity head, the same driver
    surface as the reference (``complete_computation_graph(m1, m2)``,
    ``BatchLearn(nBatch, molecule_1, molecule_2, target, lr)``,
    ``Predict(m1, m2)``; ``CCN_1D.h:658,874,1060``).

    The tower is the steerable lambda1/lambda2 (W_eye/W_one) channel-concat
    filter reduced by the per-level K (``CCN_1D.h:59-106,592-636``) — the
    exact computation of the theta filter in ``smp1d.smp1d_states`` — with
    CCN's own conventions on top, all binary-pinned in
    ``tests/test_model_parity3.py``:

    - per-vertex L1 feature normalization (``CCN_1D.h:440-448``),
    - ceil-decay channel schedule with a 16-channel floor
      (``CCN_1D.h:217``: C_l = max(ceil(C_{l-1} * decay), 16)),
    - head widths by the same decay rule (``CCN_1D.h:352-353``:
      h1 = max(ceil(nTotal * decay), 16), h2 = max(ceil(h1 * decay), 16)),
    - nChanels >= 16 enforced at construction (``CCN_1D.h:30,37``).
    """
    import math
    CCN_1D_MIN_CHANNELS = 16  # ``CCN_1D.h:30`` minimum-channel guard
    if nChanels < CCN_1D_MIN_CHANNELS:
        raise ValueError(
            f"CCN_1D requires nChanels >= {CCN_1D_MIN_CHANNELS} "
            f"(CCN_1D.h:37), got {nChanels}")
    if not (0.0 < nChanels_decay <= 1.0):
        raise ValueError("CCN_1D requires 0 < nChanels_decay <= 1 "
                         "(CCN_1D.h:38-39)")
    schedule = [nChanels]
    for _ in range(nLevels):
        schedule.append(max(int(math.ceil(schedule[-1] * nChanels_decay)),
                            CCN_1D_MIN_CHANNELS))
    nTotal = 2 * sum(schedule)
    h1 = max(int(math.ceil(nTotal * nChanels_decay)), CCN_1D_MIN_CHANNELS)
    h2 = max(int(math.ceil(h1 * nChanels_decay)), CCN_1D_MIN_CHANNELS)
    return SMPPairGraphs(1, max_nVertices_1, max_nVertices_2,
                         max_receptive_field, nLevels, nChanels, nFeatures_1,
                         nFeatures_2, channel_schedule=tuple(schedule),
                         head_dims=(h1, h2), l1_normalize_features=True,
                         seed=seed)


class GCNKernel(PairGraphModel):
    """``GCN_1D_Kernel.h``: two towers with SHARED GCN parameters; head =
    ConCat(top_X, top_Y) . W -> SquaredLoss (graph-kernel regression)."""

    def __init__(self, nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                 max_Radius, order=1, momentum_param=0.9, seed=0):
        super().__init__(optimizer="momentum", gamma=momentum_param)
        self.cfg = GCNConfig(nLevels, max_nVertices, nFeatures, nHiddens,
                             nDepth, max_Radius, order=order)
        from graphflow_tpu.optim.utils import uniform_init
        keys = jax.random.split(jax.random.PRNGKey(seed), 2)
        tower = init_gcn_params(keys[0], self.cfg)
        tower.pop("W")
        self.params = {
            "tower": tower,
            "W": uniform_init(keys[1], (2 * nHiddens,), jnp.float32),
        }
        # Registration order (GCN_1D_Kernel.h:120-128).
        order_list = []
        for l in range(nLevels + 1):
            order_list.append(f"tower/levels/{l}/W1")
            if l > 0:
                order_list.append(f"tower/levels/{l}/W2")
        self.param_order = order_list + ["W"]
        self._finish_init()

    def _prepare_1(self, graph):
        return prep.prepare_graph(graph, self.cfg.nLevels,
                                  self.cfg.max_nVertices, 1, self.cfg.nDepth)

    _prepare_2 = _prepare_1

    def _forward(self, params, g1, g2, case_mask=None):
        tower = dict(params["tower"])
        tower["W"] = jnp.zeros((self.cfg.nHiddens,))  # unused head slot
        _, top1 = gcn_forward(tower, g1, self.cfg)
        _, top2 = gcn_forward(tower, g2, self.cfg)
        return jnp.dot(jnp.concatenate([top1, top2]), params["W"])

    def _loss(self, params, g1, g2, target, case_mask=None):
        return losses.squared_loss(self._forward(params, g1, g2), target)


def GCN_1D_Kernel(nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                  max_Radius, momentum_param=0.9, seed=0):
    return GCNKernel(nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                     max_Radius, 1, momentum_param, seed)


def GCN_2D_Kernel(nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                  max_Radius, momentum_param=0.9, seed=0):
    return GCNKernel(nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                     max_Radius, 2, momentum_param, seed)


def GCN_3D_Kernel(nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                  max_Radius, momentum_param=0.9, seed=0):
    return GCNKernel(nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                     max_Radius, 3, momentum_param, seed)
