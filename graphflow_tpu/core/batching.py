"""Padded batching: stacks of PreparedGraphs as a JAX pytree.

The reference trains one molecule at a time on a rebuilt computation graph
(``SMP_omega.h:798-824``); its batch dimension is a CPU thread / CUDA stream
per replica.  Here the batch dimension is just a leading array axis: graphs
are padded to common (max_nVertices, max_receptive_field) shapes by
``prepare_graph`` and stacked here, so one jitted, vmapped step covers the
whole minibatch in one XLA program.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from graphflow_tpu.core.prep import PreparedGraph

# A GraphBatch is a plain dict pytree of stacked arrays (leading batch axis).
GraphBatch = Dict[str, Any]

_STACK_FIELDS = (
    "wl_feat", "vmask", "sizes", "nbr", "pos", "radj", "smask",
    "norm_adj", "adj", "raw_feat", "sp", "dist",
    "ell_nbr", "ell_w", "ell_nbr_a", "ell_w_a", "fo_idx",
)


def _pad_ell(f: str, vals):
    """ELLPACK structures carry a per-graph max degree D on axis 1; pad
    every graph to the batch max so they stack (sentinel index rows read
    the zero pad row; weight pads are 0, so extra slots are inert)."""
    D = max(v.shape[1] for v in vals)
    out = []
    for v in vals:
        if v.shape[1] == D:
            out.append(v)
            continue
        pad = np.zeros((v.shape[0], D - v.shape[1]), v.dtype)
        if f.startswith("ell_nbr"):
            pad += v.shape[0]                      # sentinel = pad row id V
        out.append(np.concatenate([v, pad], axis=1))
    return out


def stack_graphs(graphs: Sequence[PreparedGraph], targets=None) -> GraphBatch:
    """Stack prepared graphs into one batch pytree of device arrays."""
    batch: GraphBatch = {}
    for f in _STACK_FIELDS:
        vals = [getattr(g, f) for g in graphs]
        if any(v is None for v in vals):
            continue
        if f.startswith("ell_") and len({v.shape[1] for v in vals}) > 1:
            vals = _pad_ell(f, vals)
        batch[f] = jnp.asarray(np.stack(vals))
    batch["nVertices"] = jnp.asarray(
        np.array([g.nVertices for g in graphs], dtype=np.int32))
    if targets is not None:
        batch["target"] = jnp.asarray(np.asarray(targets, dtype=np.float32))
    return batch


def batch_size(batch: GraphBatch) -> int:
    return int(batch["vmask"].shape[0])


def index_batch(batch: GraphBatch, idx) -> GraphBatch:
    """Select a sub-batch (e.g. a minibatch slice) along the leading axis."""
    return jax.tree_util.tree_map(lambda x: x[idx], batch)


def pad_batch_to(batch: GraphBatch, size: int) -> GraphBatch:
    """Pad the batch's leading axis to ``size`` with zero-weight graphs.

    Padding graphs have vmask == 0 everywhere so they contribute exactly zero
    loss/gradient; this keeps jit shapes static across ragged final batches.
    """
    b = batch_size(batch)
    if b == size:
        return batch
    assert b < size

    def _pad(x):
        pad_width = [(0, size - b)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, pad_width)

    return jax.tree_util.tree_map(_pad, batch)


def bucket_by_size(graphs, targets=None, boundaries=(8, 16, 32, 64, 128)):
    """Group graphs into padded-size buckets (production input pipeline).

    The reference pads everything to one max_nVertices; bucketing pads each
    graph only to the smallest boundary >= its vertex count, trading a few
    XLA retraces (one per bucket shape) for much less padding waste.

    Returns {boundary: (graphs, targets)} with empty buckets omitted.
    """
    buckets = {}
    for i, g in enumerate(graphs):
        for b in boundaries:
            if g.nVertices <= b:
                gs, ts = buckets.setdefault(b, ([], []))
                gs.append(g)
                if targets is not None:
                    ts.append(targets[i])
                break
        else:
            raise ValueError(
                f"graph with {g.nVertices} vertices exceeds the largest "
                f"bucket boundary {boundaries[-1]}")
    return buckets
