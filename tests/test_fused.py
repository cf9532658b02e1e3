"""Fused bank + channel matmul parity tests (ops/fused.py)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from graphflow_tpu.ops import contractions
from graphflow_tpu.ops.fused import (
    risi18_matmul_fused, risi18_matmul_reference, smp2d_layer_fused,
)


def _inputs(rng, P=6, C=4, Co=5, B=None):
    shape = (P, P, P, C) if B is None else (B, P, P, P, C)
    T = rng.standard_normal(shape)
    a_shape = (P, P) if B is None else (B, P, P)
    A = np.abs(rng.standard_normal(a_shape))
    K = rng.standard_normal((18 * C, Co))
    return jnp.asarray(T), jnp.asarray(A), jnp.asarray(K)


class TestFused:
    def test_fused_equals_unfused(self, rng):
        T, A, K = _inputs(rng)
        a = risi18_matmul_reference(T, A, K)
        b = risi18_matmul_fused(T, A, K)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-10, atol=1e-10)

    def test_fused_with_negative_adjacency(self, rng):
        """The adj > 0 guard must be inside the fusion too."""
        T, A, K = _inputs(rng)
        A = A - float(np.median(np.asarray(A)))  # half negative
        a = risi18_matmul_reference(T, A, K)
        b = risi18_matmul_fused(T, A, K)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-10, atol=1e-10)

    def test_fused_gradients_match(self, rng):
        T, A, K = _inputs(rng, P=4, C=3, Co=3)

        def loss_ref(t, k):
            return jnp.sum(risi18_matmul_reference(t, A, k) ** 2)

        def loss_fus(t, k):
            return jnp.sum(risi18_matmul_fused(t, A, k) ** 2)

        gt_r, gk_r = jax.grad(loss_ref, argnums=(0, 1))(T, K)
        gt_f, gk_f = jax.grad(loss_fus, argnums=(0, 1))(T, K)
        np.testing.assert_allclose(np.asarray(gt_r), np.asarray(gt_f),
                                   rtol=1e-8)
        np.testing.assert_allclose(np.asarray(gk_r), np.asarray(gk_f),
                                   rtol=1e-8)

    def test_layer_leaky_relu(self, rng):
        T, A, K = _inputs(rng, Co=4)
        b = jnp.asarray(rng.standard_normal(4))
        z = smp2d_layer_fused(T, A, K, b)
        raw = risi18_matmul_fused(T, A, K) + b[None, None, :]
        np.testing.assert_allclose(
            np.asarray(z), np.where(np.asarray(raw) > 0, np.asarray(raw),
                                    0.01 * np.asarray(raw)), rtol=1e-6)
