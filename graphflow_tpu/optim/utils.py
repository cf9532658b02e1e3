"""Training utilities: gradient accumulation, parameter snapshots, init.

JAX equivalents of ``SumGradients.h`` (accumulate grads across per-example
passes), ``CacheParameters.h`` (snapshot/restore for backtracking line
search), and the engine's init helpers (``GraphFlow.h:1280-1328``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


# ----------------------------------------------------------------------
# SumGradients (reference SumGradients.h:45-67)
# ----------------------------------------------------------------------

def sum_gradients_init(params):
    """reset_sum_gradients: a zero pytree shaped like params."""
    return jax.tree_util.tree_map(jnp.zeros_like, params)


def sum_gradients_add(acc, grads):
    """cache_gradients: acc += grads."""
    return jax.tree_util.tree_map(lambda a, g: a + g, acc, grads)


# ----------------------------------------------------------------------
# CacheParameters (reference CacheParameters.h:45-60)
# ----------------------------------------------------------------------

def cache_parameters(params):
    """Snapshot: pytrees are immutable, so the snapshot is the tree itself."""
    return params


def restore_parameters(snapshot):
    return snapshot


# ----------------------------------------------------------------------
# Weight initialization
# ----------------------------------------------------------------------

def uniform_init(key, shape, dtype=jnp.float32, fan=None):
    """``GraphFlow.h:1280-1307`` uniform_init: magnitude ~ U{0, 1..9}/(10*rows)
    with random sign.  We use continuous U(-0.9, 0.9)/rows — same scale,
    proper PRNG — where ``rows`` defaults to shape[0] (the reference divides
    by nRows for matrices, by size for vectors)."""
    if fan is None:
        fan = shape[0] if len(shape) > 0 else 1
    r = 0.9 / fan
    return jax.random.uniform(key, shape, dtype, minval=-r, maxval=r)


def xavier_init(key, shape, dtype=jnp.float32, fan=None):
    """``GraphFlow.h:1322-1328`` Xavier_init: U(-sqrt(3/size), +sqrt(3/size))."""
    if fan is None:
        fan = int(np.prod(shape)) if len(shape) > 0 else 1
    r = float(np.sqrt(3.0 / fan))
    return jax.random.uniform(key, shape, dtype, minval=-r, maxval=r)


def init_like(key, tree_shapes, initializer=uniform_init, dtype=jnp.float32):
    """Initialize a dict-of-shapes pytree with per-leaf PRNG splits."""
    leaves, treedef = jax.tree_util.tree_flatten(tree_shapes,
                                                 is_leaf=lambda x: isinstance(x, tuple))
    keys = jax.random.split(key, len(leaves))
    vals = [initializer(k, s, dtype) for k, s in zip(keys, leaves)]
    return jax.tree_util.tree_unflatten(treedef, vals)
