"""Elementwise / activation ops (reference L2 op library).

Each function mirrors one reference op header's forward math; backward comes
for free from ``jax.grad``.  All are shape-polymorphic and vmap/jit friendly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def identity(x):
    """``Identity.h``: y = x."""
    return x


def sigmoid(x):
    """``Sigmoid.h:29-37``: y = 1 / (1 + exp(-x))."""
    return jax.nn.sigmoid(x)


def tanh(x):
    """``Tanh.h``: y = tanh(x)."""
    return jnp.tanh(x)


def relu(x):
    """``ReLU.h``: y = max(x, 0)."""
    return jnp.maximum(x, 0)


def leaky_relu(x, alpha: float = 0.01):
    """``LeakyReLU.h`` / ``LeakyReLU2D.h`` / ``LeakyReLU3D.h``.

    The reference defaults alpha = 0.01 when not supplied
    (``LeakyReLU.h:31``); shape rank is irrelevant here so one function
    covers all three reference classes.
    """
    return jnp.where(x > 0, x, alpha * x)


import functools as _functools


@_functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def softmax(x, axis: int = -1):
    """``Softmax.h`` / ``Softmax2D.h`` / ``Softmax3D.h``: max-subtracted
    softmax — WITH the reference's backward.

    ``Softmax::backward`` (``Softmax.h:57-61``) applies the DIAGONAL-only
    Jacobian, dL/dx_i += g_i * y_i * (1 - y_i), as if softmax were an
    elementwise sigmoid — the off-diagonal -y_i y_j terms are missing.
    Every reference Softmax node therefore trains with these gradients;
    reproducing them is what makes end-to-end training dynamics match
    (caught by the round-5 dataset closure: with the true VJP, GCN_1D's
    float64 loss curve forks from the reference geometrically from
    iteration ~6, tools/dataset_closure.py).  Use :func:`softmax_exact` for the
    true gradient."""
    return jax.nn.softmax(x, axis=axis)


def _softmax_fwd(x, axis):
    y = jax.nn.softmax(x, axis=axis)
    return y, y


def _softmax_bwd(axis, y, g):
    return (g * y * (1.0 - y),)


softmax.defvjp(_softmax_fwd, _softmax_bwd)


def softmax_exact(x, axis: int = -1):
    """Softmax with the TRUE Jacobian VJP (what the reference's backward
    would be without its diagonal approximation)."""
    return jax.nn.softmax(x, axis=axis)


def dropout(x, key, probability: float, train: bool):
    """``DropOut.h:41-67``: *keep* with ``probability`` at train time (no
    rescale), multiply by ``probability`` at eval — non-inverted dropout,
    faithfully reproduced."""
    if train:
        mask = jax.random.uniform(key, x.shape) <= probability
        return jnp.where(mask, x, 0.0)
    return probability * x


def masking(x, mask):
    """``Masking.h``: zero out entries where mask <= 0; gradient gated too."""
    return jnp.where(mask > 0.0, x, 0.0)


def norm3d(x, eps_free: bool = True):
    """``Norm3D.h``: per-depth min-max normalization of a [R, Ch, D] tensor.

    The reference treats min/max as constants in backward (gradient is
    g / range only), which is exactly what ``stop_gradient`` on the range
    achieves here.
    """
    mn = jax.lax.stop_gradient(jnp.min(x, axis=(0, 1), keepdims=True))
    mx = jax.lax.stop_gradient(jnp.max(x, axis=(0, 1), keepdims=True))
    rng = jnp.where(mn < mx, mx - mn, 1.0)
    return (x - mn) / rng


def persize_gather_refgrad(table, s, depth: int, valid=None):
    """Per-size parameter gather with the reference's SHARED-NODE backward.

    The reference wires ONE filter node per receptive-field size
    (``W_eye[size] = ScalarMatMul(lambda[size], eye)`` etc.) but re-adds
    it to the topology once per VERTEX; ``GraphFlow::backward`` therefore
    runs the shared node's backward at every occurrence over its
    accumulating gradient buffer, so vertex v's contribution to
    d lambda[s_v] is weighted by the number of chains through the shared
    prefix: w = C(r + depth - 1, depth), where r = #{u <= v : s_u = s_v}
    (vertex order) and ``depth`` = number of shared nodes on the
    lambda -> consumer path (SMP_theta/CCN/ver4/ver5: 1; SMP_2D/ver2/ver3:
    2 — e.g. lambda -> W_eye -> W(SumTensor3D/Tensor4DConcat); SMP_1D: 3 —
    lambda -> W_eye -> W_flat(Add) -> W(Reshape2D)).

    Forward value is the plain gather (forward parity is unaffected);
    only the cotangent scatter carries the weights.  Discovered via the
    round-5 gradient-parity harness (tools/parity_model_reference3.cpp
    "grad" mode); the true-gradient form is ``table[s]``.
    """
    V = s.shape[0]
    same = (s[:, None] == s[None, :])
    if valid is not None:
        same = same & (valid[None, :] > 0)
    tril = jnp.tril(jnp.ones((V, V), bool))
    r = (same & tril).sum(axis=1).astype(jnp.float32)
    w = r
    for k in range(1, depth):
        w = w * (r + k) / (k + 1)
    return _persize_gather(table, s, w)


@jax.custom_vjp
def _persize_gather(tbl, s, w):
    return tbl[s]


def _persize_gather_fwd(tbl, s, w):
    # residuals must be JAX types: keep a zero-strided view of the table
    # for shape/dtype instead of raw metadata
    return tbl[s], (jnp.zeros_like(tbl), s, w)


def _persize_gather_bwd(res, g):
    import numpy as _np
    from jax import dtypes as _dtypes

    ztbl, s, w = res
    wex = w.reshape(w.shape + (1,) * (g.ndim - 1)).astype(g.dtype)
    dtbl = ztbl + jnp.zeros_like(ztbl).at[s].add(
        (wex * g).astype(ztbl.dtype))
    return (dtbl, _np.zeros(s.shape, _dtypes.float0),
            jnp.zeros_like(w))


_persize_gather.defvjp(_persize_gather_fwd, _persize_gather_bwd)
