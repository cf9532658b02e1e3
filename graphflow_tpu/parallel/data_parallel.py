"""Multi-device data parallelism via shard_map + psum.

The replacement for the reference's thread-replica data parallelism
(``SMP_omega.h:750-792`` Threaded_BatchLearn: copy params to replicas, one
molecule per thread, serial gradient sum, single optimizer step) and its GPU
multi-stream variant (``SMP_omega_gpu_multistreams.h:131-135,754-807``):

  replica broadcast   -> parameters replicated over the mesh (P())
  thread-per-molecule -> batch axis sharded over "data" (P("data"))
  serial gradient sum -> jax.lax.psum (an NCCL all-reduce on GPUs)
  join barrier        -> implicit in SPMD program order

The whole step — per-shard forward/backward, gradient all-reduce, optimizer
update — is ONE jitted SPMD program; XLA overlaps the psum with backward
compute where profitable.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from graphflow_tpu.optim.optimizers import Optimizer


def make_dp_train_step(per_example_loss: Callable[[Any, Any, Any], jnp.ndarray],
                       opt: Optimizer, mesh: Mesh, axis="data"):
    """Build a jitted data-parallel train step.

    ``per_example_loss(params, graph_arrays, target)`` is the single-graph
    loss (e.g. a model's ``_loss``).  The returned ``step(params, opt_state,
    batch, lr)`` expects ``batch`` sharded along the leading axis over
    ``axis`` (or will be resharded by jit's in_shardings) and returns
    (params, opt_state, total_loss) with params/state replicated.

    ``axis`` may be a tuple of mesh axis names — e.g. ``("host", "data")``
    on a host x card mesh (``mesh.make_hybrid_mesh``), which shards the
    batch over both and psums gradients across hosts AND cards.
    """

    def shard_loss(params, batch):
        losses = jax.vmap(lambda g, t: per_example_loss(params, g, t))(
            batch, batch["target"])
        return losses.sum()

    def per_shard(params, batch):
        loss, grads = jax.value_and_grad(shard_loss)(params, batch)
        return (jax.lax.psum(loss, axis),
                jax.tree_util.tree_map(lambda g: jax.lax.psum(g, axis), grads))

    sharded_grad = shard_map(
        per_shard, mesh=mesh,
        in_specs=(P(), P(axis)),
        out_specs=(P(), P()),
        # The loss is a per-shard partial; gradients are psummed by hand.
        check_vma=False,
    )

    @jax.jit
    def step(params, opt_state, batch, lr):
        loss, grads = sharded_grad(params, batch)
        nBatch = batch["target"].shape[0]
        new_params, new_state = opt.update(params, opt_state, grads, lr,
                                           nBatch=nBatch)
        return new_params, new_state, loss

    return step


def shard_batch(batch, mesh: Mesh, axis="data"):
    """Device-put a stacked GraphBatch with its leading axis sharded."""
    sh = NamedSharding(mesh, P(axis))
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), batch)


def replicate(tree, mesh: Mesh):
    sh = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), tree)
