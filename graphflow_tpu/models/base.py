"""Shared model machinery: the reference's uniform L6 model API.

Every reference model is a god-class exposing
``complete_computation_graph / Learn / BatchLearn / Threaded_BatchLearn /
Predict / Feature / getLoss / save_model / load_model``
(e.g. ``SMP_omega.h:584,750,798,876,924,1033,1045``).  Here that surface is
provided once by :class:`GraphModel`; concrete models supply a config, a
parameter initializer, and a pure per-graph forward function.  The dynamic
per-example graph rebuild becomes a host-side ``prepare`` step plus a single
jitted batched train step (trace once, run for every molecule).

``Threaded_BatchLearn`` is an alias of ``BatchLearn``: the reference's
CPU-thread data parallelism (``SMP_omega.h:750-792``) replicates the model
per thread and sums gradients; here the batch axis is vmapped inside one
XLA program, and multi-device DP is handled by ``graphflow_tpu.parallel``.
"""

from __future__ import annotations

import functools
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from graphflow_tpu.core import batching, prep
from graphflow_tpu.core.graph import DenseGraph
from graphflow_tpu import optim as optim_lib
from graphflow_tpu.utils import checkpoint as ckpt


class GraphModel:
    """Base class for graph-level models (regression/classification).

    Subclasses must set:
      * ``self.param_order`` — list of pytree key-paths defining the
        reference's optimizer registration order (save/load format)
      * ``self.params`` — parameter pytree
    and implement:
      * ``_prepare(graph) -> PreparedGraph``
      * ``_forward(params, graph_arrays) -> (prediction, graph_feature)``
        (pure; graph_arrays is one element of a stacked batch)
      * ``_loss(params, graph_arrays, target) -> scalar``
    """

    def __init__(self, optimizer: str = "adam", **opt_kwargs):
        self.opt = optim_lib.make_optimizer(optimizer, **opt_kwargs)
        self.opt_state = None
        self.params: Any = None
        self.param_order: Optional[List[str]] = None
        # Weak-keyed so a collected DenseGraph can never alias a new one
        # (an id()-keyed dict silently served stale arrays when a graph was
        # garbage-collected and its id reused), and so the cache cannot
        # grow without bound over a long training run.
        self._prep_cache: "weakref.WeakKeyDictionary[DenseGraph, prep.PreparedGraph]" = (
            weakref.WeakKeyDictionary())

    # -- to be implemented by subclasses --------------------------------
    def _prepare(self, graph: DenseGraph) -> prep.PreparedGraph:
        raise NotImplementedError

    def _forward(self, params, g) -> Tuple[jnp.ndarray, jnp.ndarray]:
        raise NotImplementedError

    def _loss(self, params, g, target) -> jnp.ndarray:
        raise NotImplementedError

    # -- shared machinery ----------------------------------------------

    def _finish_init(self):
        # Reference-exact per-element Adam beta_t schedule for the nBatch
        # overload (Adam.h:108-136 advances beta_t once per scalar element
        # in REGISTRATION order — see optim.adam): needs param_order.
        if (self.param_order is not None
                and self.opt.set_element_schedule is not None):
            self.opt.set_element_schedule(self.params, self.param_order)
        self.opt_state = self.opt.init(self.params)

        def batch_loss(params, batch):
            losses = jax.vmap(lambda g, t: self._loss(params, g, t),
                              in_axes=(0, 0))(batch, batch["target"])
            return losses.sum()

        self._batch_loss = jax.jit(batch_loss)
        self._batch_grad = jax.jit(jax.value_and_grad(batch_loss))
        self._jit_forward = jax.jit(
            lambda params, batch: jax.vmap(
                lambda g: self._forward(params, g))(batch))

    def prepare(self, graph: DenseGraph) -> prep.PreparedGraph:
        """Host preprocessing (the ``complete_computation_graph`` analog),
        memoized per DenseGraph instance."""
        pg = self._prep_cache.get(graph)
        if pg is None:
            pg = self._prepare(graph)
            self._prep_cache[graph] = pg
        return pg

    def _stack(self, graphs: Sequence[DenseGraph], targets=None):
        pgs = [self.prepare(g) for g in graphs]
        return batching.stack_graphs(pgs, targets)

    # -- reference API ---------------------------------------------------

    def getLoss(self, graphs: Sequence[DenseGraph], targets) -> float:
        """Total batch loss (reference ``getLoss``, SMP_omega.h:695-704)."""
        batch = self._stack(graphs, targets)
        return float(self._batch_loss(self.params, batch))

    def Learn(self, graph: DenseGraph, target: float, learning_rate: float,
              nIterations: int = 1, epsilon: float = 1e-8):
        """Single-example training (reference per-model ``Learn``)."""
        return self.BatchLearn([graph], [target], learning_rate,
                               nIterations=nIterations, epsilon=epsilon)

    def BatchLearn(self, graphs: Sequence[DenseGraph], targets,
                   learning_rate: float, nIterations: Optional[int] = None,
                   epsilon: float = 1e-8):
        """One batched gradient step (reference ``BatchLearn``,
        ``SMP_omega.h:798-824``): returns (loss_before, loss_after).

        With ``nIterations`` set, runs the reference's backtracking-LR loop
        (``SMP_omega.h:843-871``): halve the LR and restore parameters
        whenever the loss increases.
        """
        batch = self._stack(graphs, targets)
        n = len(graphs)

        if nIterations is None:
            loss_before, grads = self._batch_grad(self.params, batch)
            self.params, self.opt_state = self.opt.update(
                self.params, self.opt_state, grads, learning_rate, nBatch=n)
            loss_after = self._batch_loss(self.params, batch)
            return float(loss_before), float(loss_after)

        def loss_and_grads(params):
            return self._batch_grad(params, batch)

        def opt_update(params, state, grads, lr, nBatch):
            return self.opt.update(params, state, grads, lr, nBatch=nBatch)

        (self.params, self.opt_state, loss0, loss1) = \
            optim_lib.backtracking_learn(
                self.params, self.opt_state, loss_and_grads, opt_update,
                learning_rate, nIterations, epsilon=epsilon, nBatch=n)
        return loss0, loss1

    # The reference's CPU-thread DP: a vmapped batch inside one XLA
    # program already fills the device; multi-device DP lives in
    # graphflow_tpu.parallel.  Kept for API parity.
    Threaded_BatchLearn = BatchLearn

    def Predict(self, graph: DenseGraph) -> float:
        """Reference ``Predict`` (SMP_omega.h:924-935)."""
        batch = self._stack([graph])
        pred, _ = self._jit_forward(self.params, batch)
        return float(np.asarray(pred)[0])

    def Threaded_Predict(self, graphs: Sequence[DenseGraph]):
        """Batched prediction (reference ``Threaded_Predict``,
        SMP_omega.h:938-1030)."""
        batch = self._stack(graphs)
        pred, _ = self._jit_forward(self.params, batch)
        return np.asarray(pred)

    def Feature(self, graph: DenseGraph) -> np.ndarray:
        """Graph-level embedding (reference ``Feature``, SMP_2D.h:748)."""
        batch = self._stack([graph])
        _, feat = self._jit_forward(self.params, batch)
        return np.asarray(feat)[0]

    # -- checkpointing ---------------------------------------------------

    def save_model(self, filename: str):
        """Whitespace-separated text dump in registration order
        (reference ``save_model``, SMP_omega.h:1033-1043)."""
        ckpt.save_text(filename, self.params, self.param_order)

    def load_model(self, filename: str):
        self.params = ckpt.load_text(filename, self.params, self.param_order)
        self.opt_state = self.opt.init(self.params)

    def cache_parameters(self):
        self._cached = (self.params, self.opt_state)

    def restore_parameters(self):
        self.params, self.opt_state = self._cached


def fit_bucketed(model: GraphModel, graphs, targets, learning_rate: float,
                 nEpochs: int, boundaries=(8, 16, 32, 64), seed: int = 0,
                 verbose: bool = False):
    """Bucketed training loop: pad each graph to its size bucket instead of
    the global max (one jit trace per bucket shape).

    Requires a model whose forward derives V from the data (the SMP
    families); the model's receptive-field cap stays fixed.  Returns the
    final epoch's total loss.
    """
    import numpy as np
    from graphflow_tpu.core import batching as batching_mod

    buckets = batching_mod.bucket_by_size(graphs, targets, boundaries)
    # Per-bucket preparation with bucket-local padding, threaded through
    # _prepare's pad_nVertices argument (no shared-config mutation).
    prepared = {}
    for b, (gs, ts) in buckets.items():
        pgs = [model._prepare(g, pad_nVertices=b) for g in gs]
        prepared[b] = (batching_mod.stack_graphs(pgs, ts), len(gs))

    rng = np.random.default_rng(seed)
    total = None
    order = list(prepared.items())
    for epoch in range(nEpochs):
        rng.shuffle(order)
        total = 0.0
        for b, (batch, n) in order:
            loss, grads = model._batch_grad(model.params, batch)
            model.params, model.opt_state = model.opt.update(
                model.params, model.opt_state, grads, learning_rate,
                nBatch=n)
            total += float(loss)
        if verbose and epoch % max(1, nEpochs // 8) == 0:
            print(f"epoch {epoch}: loss {total:.4f}")
    return total
