"""One SMP_omega level through the XLA path (models.smp2d.smp2d_level) and
its neighbor gather, against float64 NumPy brute force.

The level is gather (X f_w X^T alignment) + RisiContraction_18 + channel
matmul K + bias + LeakyReLU (reference ``SMP_omega.h:641-667``).  The brute
force below shares no code with the model: the gather is NumPy fancy
indexing and the bank is a masked sum over all five indices, one case at a
time, transcribed from the case comments of ``RisiContraction_18.h``.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from graphflow_tpu.models.smp2d import (SMP2DConfig, _gather_neighbor_tensors,
                                        smp2d_level)

# (output index pair, constraint over the index grids a, b, c, d, e)
_CASES_18 = [
    ("ab", lambda a, b, c, d, e: True),
    ("ad", lambda a, b, c, d, e: True),
    ("bc", lambda a, b, c, d, e: True),
    ("bd", lambda a, b, c, d, e: True),
    ("de", lambda a, b, c, d, e: True),
    ("ab", lambda a, b, c, d, e: c == d),
    ("ab", lambda a, b, c, d, e: d == e),
    ("ad", lambda a, b, c, d, e: b == c),
    ("ad", lambda a, b, c, d, e: b == e),
    ("bc", lambda a, b, c, d, e: a == d),
    ("bd", lambda a, b, c, d, e: a == c),
    ("bd", lambda a, b, c, d, e: a == e),
    ("bd", lambda a, b, c, d, e: c == e),
    ("de", lambda a, b, c, d, e: a == b),
    ("de", lambda a, b, c, d, e: b == c),
    ("ad", lambda a, b, c, d, e: (b == c) & (c == e)),
    ("bd", lambda a, b, c, d, e: (a == c) & (c == e)),
    ("de", lambda a, b, c, d, e: (a == b) & (b == c)),
]


def numpy_gather(state, nbr, pos):
    """T[v,i,p1,p2] = f_{nbr[v,i]}[pos[v,i,p1], pos[v,i,p2]]; id V and
    position P read zeros."""
    V, P, _, C = state.shape
    ext = np.zeros((V + 1, P + 1, P + 1, C), state.dtype)
    ext[:V, :P, :P] = state
    return ext[nbr[:, :, None, None], pos[:, :, :, None], pos[:, :, None, :]]


def numpy_bank18(T, A):
    """[P,P,P,C] x [P,P] -> [P,P,18C] with the reference's adj > 0 guard."""
    P, C = T.shape[0], T.shape[-1]
    Ap = np.where(A > 0, A, 0.0)
    a, b, c, d, e = np.ix_(*[np.arange(P)] * 5)
    X = T[:, :, :, None, None, :] * Ap[None, None, None, :, :, None]
    out = np.zeros((P, P, 18 * C))
    for k, (pair, cond) in enumerate(_CASES_18):
        masked = X * np.broadcast_to(cond(a, b, c, d, e),
                                     (P,) * 5)[..., None]
        kept = "abcde".index(pair[0]), "abcde".index(pair[1])
        summed = masked.sum(axis=tuple(i for i in range(5) if i not in kept))
        out[:, :, k * C:(k + 1) * C] = summed
    return out


def numpy_level(state, nbr, pos, radj, K, b):
    T = numpy_gather(np.asarray(state, np.float64), np.asarray(nbr),
                     np.asarray(pos))
    A = np.asarray(radj, np.float64)
    Y = np.stack([numpy_bank18(T[v], A[v]) for v in range(T.shape[0])])
    Z = Y @ np.asarray(K, np.float64) + np.asarray(b, np.float64)
    return np.where(Z > 0, Z, 0.01 * Z)


def make_case(V, P, C, Cout, dtype=np.float32, seed=0):
    """Random level inputs: sentinel neighbor ids (V), partly filled
    position maps (sentinel P) and a mixed-sign adjacency."""
    rng = np.random.RandomState(seed)
    state = rng.randn(V, P, P, C)
    nbr = rng.randint(0, V + 1, size=(V, P)).astype(np.int32)
    pos = np.full((V, P, P), P, np.int32)
    for v in range(V):
        for i in range(P):
            if nbr[v, i] != V:
                n_valid = rng.randint(1, P + 1)
                pos[v, i, :n_valid] = rng.permutation(P + 1)[:n_valid]
    radj = rng.randn(V, P, P)
    K = rng.randn(18 * C, Cout) * 0.1
    b = rng.randn(Cout) * 0.1
    cast = lambda x: np.asarray(jnp.asarray(x, dtype))
    return cast(state), nbr, pos, cast(radj), cast(K), cast(b)


def run_level(state, nbr, pos, radj, K, b):
    V, P, _, C = state.shape
    cfg = SMP2DConfig(max_nVertices=V, max_receptive_field=P, nLevels=1,
                      nChanels=C, nFeatures=4, nDepth=0)
    out = jax.jit(lambda *a: smp2d_level(cfg, *a))(state, nbr, pos, radj, K,
                                                   b)
    return np.asarray(out, np.float64)


def rel_err(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1.0)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10),
                                       (np.float32, 1e-4)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("V,P,C,Cout", [(6, 4, 8, 8), (5, 8, 8, 16),
                                        (4, 4, 16, 8)])
def test_level_matches_brute_force(V, P, C, Cout, dtype, tol):
    args = make_case(V, P, C, Cout, dtype)
    assert rel_err(run_level(*args), numpy_level(*args)) < tol


def test_level_negative_adjacency_zeroes_weighted_cases():
    """An all-negative adjacency must zero every adjacency-weighted case
    (the adj > 0 guard): only bias survives the bank."""
    state, nbr, pos, radj, K, b = make_case(5, 4, 8, 8, np.float64, seed=3)
    radj = -np.abs(radj) - 0.1
    got = run_level(state, nbr, pos, radj, K, b)
    want = numpy_level(state, nbr, pos, radj, K, b)
    bias_only = np.where(b > 0, b, 0.01 * b)
    np.testing.assert_allclose(want, np.broadcast_to(bias_only, want.shape))
    assert rel_err(got, want) < 1e-12


def test_level_all_sentinel_vertex():
    """A vertex whose whole receptive field is absent gets bias-only rows."""
    state, nbr, pos, radj, K, b = make_case(4, 4, 8, 8, np.float64, seed=5)
    nbr[2, :] = 4
    pos[2] = 4
    got = run_level(state, nbr, pos, radj, K, b)
    np.testing.assert_allclose(got[2], np.broadcast_to(
        np.where(b > 0, b, 0.01 * b), got[2].shape), rtol=1e-12)
    assert rel_err(got, numpy_level(state, nbr, pos, radj, K, b)) < 1e-10


def test_level_bf16():
    """bf16 state, adjacency and weights (f32 accumulation in the bank)
    track the float64 brute force at bf16 tolerance."""
    args = make_case(6, 16, 8, 8, jnp.bfloat16, seed=13)
    ref = numpy_level(*[np.asarray(x, np.float64) if x.dtype != np.int32
                        else x for x in args])
    assert rel_err(run_level(*args), ref) < 3e-2


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("V,Vsrc,P,C", [(6, 6, 4, 8), (5, 9, 8, 3),
                                        (4, 4, 16, 8)])
def test_gather_bit_exact(V, Vsrc, P, C, dtype):
    """The gather copies values: bit-equal to NumPy fancy indexing, also
    from a source with more rows than the output (the partitioned path's
    halo-extended buffer)."""
    rng = np.random.RandomState(V * 100 + P)
    state = np.asarray(jnp.asarray(rng.randn(Vsrc, P, P, C), dtype))
    nbr = rng.randint(0, Vsrc + 1, size=(V, P)).astype(np.int32)
    pos = rng.randint(0, P + 1, size=(V, P, P)).astype(np.int32)
    state_pad = np.pad(state, ((0, 0), (0, 1), (0, 1), (0, 0)))
    got = np.asarray(jax.jit(_gather_neighbor_tensors)(state_pad, nbr, pos))
    want = numpy_gather(state, nbr, pos)
    assert got.dtype == want.dtype and got.shape == (V, P, P, P, C)
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))
