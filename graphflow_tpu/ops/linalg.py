"""Arithmetic / linear-algebra ops (reference L2 op library).

The reference implements each of these as a scalar-loop C++ class; here they
are single XLA ops.  Functions are named after their
reference headers so the component inventory (SURVEY.md 2.3) maps 1:1.

Convention: tensors-with-channels are laid out [..., spatial..., C] with the
channel ("depth") axis last, matching the reference's Tensor3D index order
(row, column, depth) -> row-major with depth fastest (``Tensor3D.h:37``).
"""

from __future__ import annotations

import jax.numpy as jnp


def add(a, b):
    """``Add.h``: elementwise a + b."""
    return a + b


def subtract(a, b):
    """``Subtract.h``: elementwise a - b."""
    return a - b


def multiply(a, b):
    """``Multiply.h``: Hadamard product."""
    return a * b


def inner_product(a, b):
    """``InnerProduct.h``: <a, b> over flattened vectors."""
    return jnp.sum(a * b)


def outer_product(a, b):
    """``OuterProduct.h``: a b^T."""
    return jnp.outer(a, b)


def transpose(m):
    """``Transpose.h``."""
    return m.T


def scalar_matmul(s, m):
    """``ScalarMatMul.h``: scalar * matrix (s may be a 1-element vector)."""
    return jnp.reshape(s, ())[()] * m if hasattr(s, "shape") and s.size == 1 else s * m


def mat_vec_mul(m, v):
    """``MatVecMul.h``: [R, C] @ [C] -> [R]."""
    return m @ v


def matmul(a, b):
    """``MatMul.h:48-67``: dense matrix product."""
    return jnp.dot(a, b, preferred_element_type=jnp.float32).astype(a.dtype)


def mat_tensor_mul(m, t):
    """``MatTensorMul.h``: matrix times each depth-slice of a 3-D tensor.

    m: [R, S], t: [S, Cc, D] -> [R, Cc, D]  (depth last).
    """
    return jnp.einsum("rs,scd->rcd", m, t)


def tensor_mat_mul(t, m):
    """``TensorMatMul.h``: each depth-slice of t times m.

    t: [R, S, D], m: [S, Cc] -> [R, Cc, D].
    """
    return jnp.einsum("rsd,sc->rcd", t, m)


def tensor_mul(t1, t2):
    """``TensorMul.h``: per-depth matrix product of two 3-D tensors.

    t1: [R, S, D], t2: [S, Cc, D] -> [R, Cc, D].
    """
    return jnp.einsum("rsd,scd->rcd", t1, t2)


def tensor4d_tensor3d_mul(t4, t3):
    """``Tensor4DTensor3DMul.h``: contract a 4-D weight with a 3-D tensor.

    t4: [R, S, D1, D2], t3: [S, Cc, D1] -> [R, Cc, D2]: for each output
    depth d2, sum over (s, d1) of t4[r, s, d1, d2] * t3[s, c, d1].
    """
    return jnp.einsum("rsxy,scx->rcy", t4, t3)


def custom_matmul_tensor(m, t):
    """``CustomMatMulTensor.h:46-62``: channel mixing of a 3-D tensor.

    m: [Dout, Din], t: [R, Cc, Din] -> [R, Cc, Dout]:
    out[i, j, k] = sum_v m[k, v] * t[i, j, v].
    """
    return jnp.einsum("kv,ijv->ijk", m, t)


def vector_broadcast_mat(v, m):
    """``VectorBroadcastMat.h``: out[:, :, c] = v[c] * m — the steerable
    filter builder (lambda_c broadcast over a base matrix)."""
    return m[:, :, None] * v[None, None, :]


def mat_broadcast_mat(weights, m):
    """``MatBroadcastMat.h``: out[:, :, i, j] = weights[i, j] * m."""
    return m[:, :, None, None] * weights[None, None, :, :]


def vector_add_matrix(v, m):
    """``VectorAddMatrix.h``: add bias v[c] to every row of m [R, C]."""
    return m + v[None, :]


def vector_add_tensor(v, t):
    """``VectorAddTensor.h``: add per-channel bias v[d] to t [R, Cc, D]."""
    return t + v[None, None, :]


def linear_gram(X):
    """``LinearGram.h``: Gram matrix G[x, y] = <X[x], X[y]> of stacked rows."""
    return X @ X.T
