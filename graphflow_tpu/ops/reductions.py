"""Reductions, reshapes, stacking, gathers (reference L2 op library).

Set-valued reference ops (SumVectors, RisiLayer*, LinearGram, ...) take their
operand sets as a stacked leading axis here — the natural XLA layout — with an
optional mask for padded slots.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def sum_components(v):
    """``SumComponents.h``: scalar sum of all entries."""
    return jnp.sum(v)


def sum_vectors(X, mask=None):
    """``SumVectors.h``: sum a set of vectors. X: [N, D], mask: [N]."""
    if mask is not None:
        X = X * mask[:, None]
    return X.sum(axis=0)


def average_vectors(X, mask=None):
    """``AverageVectors.h``: mean of a set of vectors."""
    if mask is None:
        return X.mean(axis=0)
    denom = jnp.maximum(mask.sum(), 1.0)
    return (X * mask[:, None]).sum(axis=0) / denom


def sum_matrices(Ms, mask=None):
    """``SumMatrices.h``: sum a set of matrices. Ms: [N, R, C]."""
    if mask is not None:
        Ms = Ms * mask[:, None, None]
    return Ms.sum(axis=0)


def sum_tensor3d(Ts, mask=None):
    """``SumTensor3D.h``: sum a set of 3-D tensors. Ts: [N, R, C, D]."""
    if mask is not None:
        Ts = Ts * mask[:, None, None, None]
    return Ts.sum(axis=0)


def sum_rows(m):
    """``SumRows.h``: column vector of row sums."""
    return m.sum(axis=1)


def shrink_matrix(m, axis: int):
    """``ShrinkMatrix.h``: row-sum (axis=0) or column-sum (axis=1)."""
    return m.sum(axis=axis)


def shrink_tensor(t):
    """``ShrinkTensor.h:37-51``: sum over rows x columns keeping depth —
    pools a vertex tensor [R, Cc, D] to a channel vector [D]."""
    return t.sum(axis=(0, 1))


def concat(vectors):
    """``ConCat.h`` / ``ConcatVectors.h``: concatenate flat vectors."""
    return jnp.concatenate([jnp.ravel(v) for v in vectors])


def matrix_concat(ms):
    """``MatrixConcat.h``: stack matrices along rows."""
    return jnp.concatenate(ms, axis=0)


def tensor3d_concat(ts):
    """``Tensor3DConcat.h``: concatenate 3-D tensors along depth."""
    return jnp.concatenate(ts, axis=-1)


def tensor4d_concat(ts):
    """``Tensor4DConcat.h``: concatenate 4-D tensors along the last channel axis."""
    return jnp.concatenate(ts, axis=-1)


def stack_tensor3d(ts):
    """``StackTensor3D.h`` (+``_thread``): N x [R, C, D] -> [N, R, C, D].

    The reference's per-row CPU threads (``StackTensor3D_thread.h:95-117``)
    are unnecessary: stacking is a layout no-op for XLA.
    """
    return jnp.stack(ts, axis=0) if isinstance(ts, (list, tuple)) else ts


def shuffle_matrix(m, sequence):
    """``ShuffleMatrix.h``: row-gather by an index sequence (PATCHY-SAN
    input assembly)."""
    return m[sequence.astype(jnp.int32)]


def sort_vector(v):
    """``Sort.h``: ascending sort; gradient routes through the permutation
    (automatic with jnp.sort's VJP)."""
    return jnp.sort(v)


def kmax(v, k: int):
    """``KMax.h``: the K largest entries in ascending order, original-order
    gradients."""
    return jnp.sort(v)[-k:]


def vertex_representation(feature, weight, vertex: int, n: int):
    """``VertexRepresentation.h``: scatter <feature, weight> into slot
    ``vertex`` of an n-vector."""
    return jnp.zeros((n,), feature.dtype).at[vertex].set(jnp.sum(feature * weight))


# ----------------------------------------------------------------------
# CCN neighbor aggregations (RisiLayer family)
# ----------------------------------------------------------------------

def risi_layer_1d(X, mask=None):
    """``RisiLayer1D.h:38-59``: elementwise sum of a vector set."""
    return sum_vectors(X, mask)


def risi_layer_2d(X, mask=None):
    """``RisiLayer2D.h:37-51``: second-order symmetrized aggregation.

    y[i] = sum_{u<v} sum_k (x_u[i] x_v[k] + x_u[k] x_v[i])
         = sum_u x_u[i] * (S_tot - S_u),   S_u = sum_k x_u[k]
    — the closed form turns the reference's O(n^2 D^2) loop into O(n D).
    """
    if mask is not None:
        X = X * mask[:, None]
    s = X.sum(axis=1)            # [N]
    s_tot = s.sum()
    return (X * (s_tot - s)[:, None]).sum(axis=0)


def risi_layer_3d(X, mask=None):
    """``RisiLayer3D.h:43-69``: third-order products over ordered distinct
    triples: Y[x,y,z] = sum_{i,j,v distinct} x_i[x] x_j[y] x_v[z].

    Computed by inclusion-exclusion over the distinctness constraint instead
    of the reference's O(n^3 D^3) loop:
      sum_distinct = u^3 - (sum_i xx u-perms) + 2 sum_i x_i^3
    where u = sum_i x_i and "xx u-perms" are the three placements of a
    repeated index.  Returns the [D, D, D] tensor (reference flattens with x
    fastest; flatten order is the caller's concern).
    """
    if mask is not None:
        X = X * mask[:, None]
    u = X.sum(axis=0)                                    # [D]
    uuu = jnp.einsum("x,y,z->xyz", u, u, u)
    xx_u = jnp.einsum("ix,iy,z->xyz", X, X, u)           # i==j slot
    x_u_x = jnp.einsum("ix,y,iz->xyz", X, u, X)          # i==v slot
    u_xx = jnp.einsum("x,iy,iz->xyz", u, X, X)           # j==v slot
    xxx = jnp.einsum("ix,iy,iz->xyz", X, X, X)
    return uuu - xx_u - x_u_x - u_xx + 2.0 * xxx


def reshape2d(x, nRows, nColumns):
    """``Reshape2D.h``: view as [nRows, nColumns]."""
    return jnp.reshape(x, (nRows, nColumns))


def reshape3d(x, nRows, nColumns, nDepth):
    """``Reshape3D.h``: view as [nRows, nColumns, nDepth] (depth last)."""
    return jnp.reshape(x, (nRows, nColumns, nDepth))


def reshape4d(x, nRows, nColumns, nChanels1, nChanels2):
    """``Reshape4D.h``."""
    return jnp.reshape(x, (nRows, nColumns, nChanels1, nChanels2))
