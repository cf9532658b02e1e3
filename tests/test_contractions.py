"""Contraction-bank correctness tests.

The analog of the reference's kernel parity harness
(tests/test_RisiContraction_18_gpu.cu): the optimized einsum bank is checked
against (a) an independent brute-force NumPy evaluator transcribed directly
from the reference's case comments, (b) the generic case-table engine, plus
the reference's 18-case pairwise-uniqueness check and a permutation-
covariance property test.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from graphflow_tpu.ops import contractions as C


# ----------------------------------------------------------------------
# Independent brute force (5 nested loops with explicit constraints),
# transcribed from RisiContraction_18.h:98-322 / _50.h case comments.
# ----------------------------------------------------------------------

# (output_pair, constraint) per case; constraint is a predicate over
# (a, b, c, d, e) index values.
_CASES_18 = [
    (("a", "b"), lambda a, b, c, d, e: True),                    # 1  (1/50)
    (("a", "d"), lambda a, b, c, d, e: True),                    # 2  (3/50)
    (("b", "c"), lambda a, b, c, d, e: True),                    # 3  (5/50)
    (("b", "d"), lambda a, b, c, d, e: True),                    # 4  (6/50)
    (("d", "e"), lambda a, b, c, d, e: True),                    # 5  (10/50)
    (("a", "b"), lambda a, b, c, d, e: c == d),                  # 6  (11/50)
    (("a", "b"), lambda a, b, c, d, e: d == e),                  # 7  (13/50)
    (("a", "d"), lambda a, b, c, d, e: b == c),                  # 8  (17/50)
    (("a", "d"), lambda a, b, c, d, e: b == e),                  # 9  (18/50)
    (("b", "c"), lambda a, b, c, d, e: a == d),                  # 10 (23/50)
    (("b", "d"), lambda a, b, c, d, e: a == c),                  # 11 (26/50)
    (("b", "d"), lambda a, b, c, d, e: a == e),                  # 12 (27/50)
    (("b", "d"), lambda a, b, c, d, e: c == e),                  # 13 (28/50)
    (("d", "e"), lambda a, b, c, d, e: a == b),                  # 14 (38/50)
    (("d", "e"), lambda a, b, c, d, e: b == c),                  # 15 (40/50)
    (("a", "d"), lambda a, b, c, d, e: b == c == e),             # 16 (43/50)
    (("b", "d"), lambda a, b, c, d, e: a == c == e),             # 17 (46/50)
    (("d", "e"), lambda a, b, c, d, e: a == b == c),             # 18 (50/50)
]


def brute_force_cases(T, A, cases, positive_guard):
    """Literal 6-deep loop like RisiContraction_18::DEPRECATED_forward."""
    N, _, _, Cc = T.shape
    out = np.zeros((N, N, len(cases) * Cc))
    names = "abcde"
    for a in range(N):
        for b in range(N):
            for c in range(N):
                for d in range(N):
                    for e in range(N):
                        adj = A[d, e]
                        if positive_guard and adj <= 0:
                            continue
                        vals = dict(a=a, b=b, c=c, d=d, e=e)
                        for k, (fix, cond) in enumerate(cases):
                            if cond(a, b, c, d, e):
                                x, y = vals[fix[0]], vals[fix[1]]
                                out[x, y, k * Cc:(k + 1) * Cc] += T[a, b, c] * adj
    return out


def random_inputs(rng, N=4, Cc=3, symmetric=True, signed=False):
    T = rng.standard_normal((N, N, N, Cc))
    if symmetric:
        T = 0.5 * (T + T.transpose(1, 0, 2, 3))  # symmetry not required; mix
    A = rng.random((N, N))
    A = 0.5 * (A + A.T)
    if signed:
        A = A - 0.5  # exercise the adj > 0 guard with negative entries
    np.fill_diagonal(A, 1.0)
    return T, A


class TestRisi18:
    def test_matches_brute_force(self, rng):
        T, A = random_inputs(rng, N=4, Cc=2, signed=True)
        want = brute_force_cases(T, A, _CASES_18, positive_guard=True)
        got = np.asarray(C.risi_contraction_18(jnp.asarray(T), jnp.asarray(A)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    def test_spec_engine_agrees(self, rng):
        T, A = random_inputs(rng, N=5, Cc=3, signed=True)
        a = np.asarray(C.risi_contraction_18(jnp.asarray(T), jnp.asarray(A)))
        b = np.asarray(C.risi_contraction_18_spec(jnp.asarray(T), jnp.asarray(A)))
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)

    def test_cases_pairwise_distinct(self, rng):
        """The reference's uniqueness check
        (test_RisiContraction_18_gpu.cu:172-192): the 18 case outputs must be
        pairwise distinct on random input."""
        T = rng.standard_normal((5, 5, 5, 1))
        A = rng.random((5, 5))  # asymmetric: distinctness is a property of
        np.fill_diagonal(A, 1.0)  # the case functionals, not special inputs
        y = np.asarray(C.risi_contraction_18(jnp.asarray(T), jnp.asarray(A)))
        slabs = [y[:, :, k] for k in range(18)]
        for i in range(18):
            for j in range(i + 1, 18):
                assert np.abs(slabs[i] - slabs[j]).max() > 1e-6, (i, j)

    def test_permutation_covariance(self, rng):
        """Permuting the stacked tensors and adjacency jointly permutes the
        output spatially — the algebraic property the CCN models rely on."""
        N, Cc = 5, 2
        T, A = random_inputs(rng, N=N, Cc=Cc)
        perm = np.array([3, 0, 4, 1, 2])
        # permute all three tensor indices and both adjacency indices
        Tp = T[perm][:, perm][:, :, perm]
        Ap = A[perm][:, perm]
        y = np.asarray(C.risi_contraction_18(jnp.asarray(T), jnp.asarray(A)))
        yp = np.asarray(C.risi_contraction_18(jnp.asarray(Tp), jnp.asarray(Ap)))
        np.testing.assert_allclose(yp, y[perm][:, perm], rtol=1e-5, atol=1e-5)

    def test_zero_padding_invariance(self, rng):
        """Padding T and A with zeros must not change the valid block — the
        property that makes static-shape batching exact."""
        T, A = random_inputs(rng, N=3, Cc=2)
        P = 5
        Tp = np.zeros((P, P, P, 2)); Tp[:3, :3, :3] = T
        Ap = np.zeros((P, P)); Ap[:3, :3] = A
        y = np.asarray(C.risi_contraction_18(jnp.asarray(T), jnp.asarray(A)))
        yp = np.asarray(C.risi_contraction_18(jnp.asarray(Tp), jnp.asarray(Ap)))
        np.testing.assert_allclose(yp[:3, :3], y, rtol=1e-5, atol=1e-5)
        # and the padded region is exactly zero
        assert np.abs(yp[3:]).max() == 0 and np.abs(yp[:, 3:]).max() == 0

    def test_gradients_flow(self, rng):
        T, A = random_inputs(rng, N=3, Cc=2)

        def f(t):
            return jnp.sum(C.risi_contraction_18(t, jnp.asarray(A)) ** 2)

        g = jax.grad(f)(jnp.asarray(T))
        assert np.isfinite(np.asarray(g)).all()
        # numerical check on one coordinate
        eps = 1e-4
        Tp = T.copy(); Tp[1, 2, 0, 1] += eps
        Tm = T.copy(); Tm[1, 2, 0, 1] -= eps
        num = (f(jnp.asarray(Tp)) - f(jnp.asarray(Tm))) / (2 * eps)
        np.testing.assert_allclose(g[1, 2, 0, 1], num, rtol=1e-3)


class TestOtherBanks:
    def test_risi4_brute_force(self, rng):
        N, Cc = 4, 2
        T = rng.standard_normal((N, N, N, Cc))
        got = np.asarray(C.risi_contraction_4(jnp.asarray(T)))
        want = np.zeros((N, N, 4 * Cc))
        for a in range(N):
            for b in range(N):
                for c in range(N):
                    want[a, b, 0 * Cc:1 * Cc] += T[a, b, c]
                    want[b, c, 1 * Cc:2 * Cc] += T[a, b, c]
        for a in range(N):
            for c in range(N):
                want[a, c, 2 * Cc:3 * Cc] += T[a, a, c]
        for a in range(N):
            for b in range(N):
                want[a, b, 3 * Cc:4 * Cc] += T[a, b, b]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    def test_risi10_brute_force(self, rng):
        cases_10 = [
            (("a", "b"), lambda a, b, c, d, e: True),
            (("a", "c"), lambda a, b, c, d, e: True),
            (("a", "d"), lambda a, b, c, d, e: True),
            (("a", "e"), lambda a, b, c, d, e: True),
            (("b", "c"), lambda a, b, c, d, e: True),
            (("b", "d"), lambda a, b, c, d, e: True),
            (("b", "e"), lambda a, b, c, d, e: True),
            (("c", "d"), lambda a, b, c, d, e: True),
            (("c", "e"), lambda a, b, c, d, e: True),
            (("d", "e"), lambda a, b, c, d, e: True),
        ]
        T, A = random_inputs(rng, N=3, Cc=2, signed=True)
        # no positivity guard for the 10-case bank (plain T.A product)
        want = brute_force_cases(T, A, cases_10, positive_guard=False)
        got = np.asarray(C.risi_contraction_10(jnp.asarray(T), jnp.asarray(A)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    def test_risi50_subset_consistency(self, rng):
        """The 18-bank must equal the corresponding 50-bank case slabs (after
        applying the 18-bank's positivity guard to A)."""
        T, A = random_inputs(rng, N=4, Cc=2)
        y50 = np.asarray(C.risi_contraction_50(jnp.asarray(T), jnp.asarray(A)))
        y18 = np.asarray(C.risi_contraction_18(jnp.asarray(T), jnp.asarray(A)))
        Cc = 2
        for k, c50 in enumerate(C._SUBSET_18):
            np.testing.assert_allclose(
                y18[:, :, k * Cc:(k + 1) * Cc],
                y50[:, :, (c50 - 1) * Cc:c50 * Cc],
                rtol=1e-5, atol=1e-5, err_msg=f"case {k+1} (={c50}/50)")

    def test_risi50_case_count_and_distinct(self, rng):
        T, A = random_inputs(rng, N=5, Cc=1)
        y = np.asarray(C.risi_contraction_50(jnp.asarray(T), jnp.asarray(A)))
        assert y.shape == (5, 5, 50)

    def test_dropout_train_and_eval(self, rng):
        T, A = random_inputs(rng, N=3, Cc=2)
        key = jax.random.PRNGKey(0)
        mask = C.dropout_case_mask(key, nKept=6, train=True)
        assert float(mask.sum()) == 6.0
        y = C.risi_contraction_18_dropout(jnp.asarray(T), jnp.asarray(A), mask)
        y_full = C.risi_contraction_18(jnp.asarray(T), jnp.asarray(A))
        kept = np.asarray(mask).repeat(2)
        np.testing.assert_allclose(np.asarray(y), np.asarray(y_full) * kept,
                                   rtol=1e-6)
        mask_eval = C.dropout_case_mask(key, nKept=6, train=False)
        np.testing.assert_allclose(np.asarray(mask_eval), 6 / 18)


def test_optimized_50_and_10_match_generic_spec():
    """The round-4 shared-reduction 50/10 banks must reproduce the generic
    case-table engine exactly (signed adjacency: neither bank guards)."""
    import numpy as np
    import jax.numpy as jnp
    from graphflow_tpu.ops import contractions as ct

    rng = np.random.RandomState(42)
    for N, C in [(4, 3), (6, 5)]:
        T = jnp.asarray(rng.randn(N, N, N, C))
        A = jnp.asarray(rng.randn(N, N))
        for opt, spec in [(ct.risi_contraction_50, ct.risi_contraction_50_spec),
                          (ct.risi_contraction_10, ct.risi_contraction_10_spec)]:
            a, b = np.asarray(opt(T, A)), np.asarray(spec(T, A))
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-13)


def test_fused_bank_matmul_50_and_10_match_spec():
    """risi_contraction_{50,10}_matmul == spec-bank reshape @ K (f64)."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from graphflow_tpu.ops import contractions as ct

    rng = np.random.RandomState(3)
    V, N, C, Co = 3, 5, 3, 4
    T = jnp.asarray(rng.randn(V, N, N, N, C))
    A = jnp.asarray(rng.randn(V, N, N))
    for nCon, fused, spec in (
            (50, ct.risi_contraction_50_matmul, ct.risi_contraction_50_spec),
            (10, ct.risi_contraction_10_matmul, ct.risi_contraction_10_spec)):
        K = jnp.asarray(rng.randn(nCon * C, Co))
        want = jnp.einsum(
            "vxyk,ko->vxyo",
            jax.vmap(spec)(T, A).reshape(V, N, N, nCon * C), K)
        got = fused(T, A, K)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-11, atol=1e-12)
