"""The *_physics model family: raw features + optional Coulomb adjacency +
a per-level-features MLP head.

Reference ``SMP_omega_physics.h`` / ``SMP_beta_physics.h`` /
``SMP_gamma_physics.h`` / ``SMP_theta_physics.h``.  All four share the same
surface, which differs from their non-physics parents in three ways:

  * RAW vertex features only — no WL histograms, no WL vertex ranking
    (their ``complete_computation_graph`` never calls ``weisfeiler_lehman``
    / ``rank_vertices``; receptive fields keep insertion order),
  * optional Coulomb reduced adjacency: with ``use_coulomb`` the per-phi
    block copies ``molecule->coulomb[v1][v2]`` verbatim INCLUDING the
    diagonal; without it the usual diag-1 0/1 block
    (``SMP_omega_physics.h:436-461``),
  * per-level graph features concatenated into an MLP head:
    ``hidden = LeakyReLU(W1 @ concat(level_feature[0..L]))``,
    ``predict = <hidden, W2>`` with nHidden = nTotalFeatures / 2
    (``SMP_omega_physics.h:211-239,585-592``) — unlike the parents' single
    top-level InnerProduct head.

Adam, SquaredLoss, one graph per example.  Towers are the existing
config-driven ones: contraction-18 (omega/beta), contraction-4 (gamma),
first-order theta (theta) — all binary-pinned; the physics head itself is
pinned in ``tests/test_model_parity3.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from graphflow_tpu.core import prep
from graphflow_tpu.core.graph import DenseGraph
from graphflow_tpu.models.base import GraphModel
from graphflow_tpu.models.smp1d import (SMP1DConfig, init_smp1d_params,
                                        smp1d_level_features)
from graphflow_tpu.models.smp2d import (SMP2DConfig, init_smp2d_params,
                                        smp2d_level_features)
from graphflow_tpu.ops import activations, losses
from graphflow_tpu.optim.utils import uniform_init


class SMPPhysics(GraphModel):
    """Shared driver for the four physics models."""

    def __init__(self, order: int, max_nVertices: int,
                 max_receptive_field, nLevels: int, nChanels: int,
                 nFeatures: int, use_coulomb: bool = False,
                 contraction: int = 18, seed: int = 0):
        super().__init__(optimizer="adam")
        self.order = order
        cfg_cls = SMP2DConfig if order == 2 else SMP1DConfig
        extra = ({"use_coulomb": use_coulomb, "contraction": contraction}
                 if order == 2 else {})
        # Like the pairgraph towers, ALL physics towers HALVE channels per
        # level: C_l = max(C_{l-1} / 2, 1) (``SMP_omega_physics.h:142-144``
        # and the same lines in beta/gamma/theta) — caught by the round-5
        # binary-parity harness.
        schedule = [nChanels]
        for _ in range(nLevels):
            schedule.append(max(schedule[-1] // 2, 1))
        self.cfg = cfg_cls(
            max_nVertices=max_nVertices,
            max_receptive_field=max_receptive_field, nLevels=nLevels,
            nChanels=nChanels, nFeatures=nFeatures, nDepth=0,
            has_WL_ordering=False, use_wl_features=False,
            channel_schedule=tuple(schedule), **extra)
        self.use_coulomb = use_coulomb

        # nTotalFeatures = sum of the per-level channel counts; nHidden =
        # nTotal / 2 (SMP_omega_physics.h:211-233).
        nTotal = sum(schedule)
        nHidden = nTotal // 2
        keys = jax.random.split(jax.random.PRNGKey(seed), 3)
        init_fn = init_smp2d_params if order == 2 else init_smp1d_params
        tower = init_fn(keys[0], self.cfg)
        tower.pop("W")   # the parents' top-level head is absent here
        self.params = {
            "tower": tower,
            "W1": uniform_init(keys[1], (nHidden, nTotal), jnp.float32),
            "W2": uniform_init(keys[2], (nHidden,), jnp.float32),
        }
        # Registration order (SMP_omega_physics.h:254-263).  The theta
        # tower's per-size lambda/b interleave is approximated by whole
        # arrays here (affects only the reference text-checkpoint layout
        # and the per-element Adam beta_t offsets within a level block).
        if order == 2:
            per_level = ["K", "b"]
        else:
            per_level = ["lambda1", "lambda2", "b", "K"]
        self.param_order = (["tower/H"]
                            + [f"tower/levels/{l}/{k}"
                               for l in range(nLevels) for k in per_level]
                            + ["W1", "W2"])
        self._finish_init()

    def _prepare(self, graph: DenseGraph):
        return prep.prepare_graph(
            graph, self.cfg.nLevels, self.cfg.max_nVertices,
            self.cfg.max_receptive_field, 0, has_WL_ordering=False,
            use_wl_features=False, use_coulomb=self.use_coulomb)

    def _forward(self, params, g):
        if self.order == 2:
            feats = smp2d_level_features(params["tower"], g, self.cfg)
        else:
            feats = smp1d_level_features(params["tower"], g, self.cfg)
        gf = jnp.concatenate(feats)
        hidden = activations.leaky_relu(params["W1"] @ gf)
        return jnp.dot(hidden, params["W2"]), gf

    def _loss(self, params, g, target):
        pred, _ = self._forward(params, g)
        return losses.squared_loss(pred, target)


def SMP_omega_physics(max_nVertices, max_receptive_field, nLevels, nChanels,
                      nFeatures, use_coulomb=False, seed=0) -> SMPPhysics:
    """``SMP_omega_physics.h:31-61``: contraction-18 tower, receptive-field
    cap; ``use_coulomb`` defaults False (the bool-first reference ctor
    enables it)."""
    return SMPPhysics(2, max_nVertices, max_receptive_field, nLevels,
                      nChanels, nFeatures, use_coulomb=use_coulomb,
                      contraction=18, seed=seed)


def SMP_beta_physics(max_nVertices, nLevels, nChanels, nFeatures,
                     use_coulomb=False, seed=0) -> SMPPhysics:
    """``SMP_beta_physics.h:31-58``: omega_physics without the cap."""
    return SMPPhysics(2, max_nVertices, None, nLevels, nChanels, nFeatures,
                      use_coulomb=use_coulomb, contraction=18, seed=seed)


def SMP_gamma_physics(max_nVertices, max_receptive_field, nLevels, nChanels,
                      nFeatures, use_coulomb=False, seed=0) -> SMPPhysics:
    """``SMP_gamma_physics.h:31-60``: the RisiContraction_4 variant."""
    return SMPPhysics(2, max_nVertices, max_receptive_field, nLevels,
                      nChanels, nFeatures, use_coulomb=use_coulomb,
                      contraction=4, seed=seed)


def SMP_theta_physics(max_nVertices, max_receptive_field, nLevels, nChanels,
                      nFeatures, seed=0) -> SMPPhysics:
    """``SMP_theta_physics.h:31-56``: first-order theta tower (no Coulomb
    mode — the 1st-order tower never touches the reduced adjacency)."""
    return SMPPhysics(1, max_nVertices, max_receptive_field, nLevels,
                      nChanels, nFeatures, seed=seed)
