"""Second-order SMP model tests.

Mirrors the reference test genres (SURVEY.md section 4): toy-molecule
convergence (tests/test_SMP_omega.cpp), the permutation-invariance property
test (tests/test_graph_permutation_invariant.cpp), and save/load round-trips
— as real asserts instead of print-and-eyeball.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from graphflow_tpu.core.graph import DenseGraph
from graphflow_tpu.models import (
    SMP2D, SMP2DConfig, SMP_omega, SMP_beta, SMP_gamma, SMP_2D_ver6,
    SMP_2D_ver7, SMP_omega_physics,
)
from tests.molecules import all_molecules, molecule


@pytest.fixture(scope="module")
def molecules():
    return all_molecules()


def test_smp_omega_toy_convergence(molecules):
    """The reference's flagship demo (test_SMP_omega.cpp:149-210): 4 toy
    molecules, regression target = nVertices; loss must drop steadily and
    predictions approach targets."""
    graphs, targets = molecules
    m = SMP_omega(max_nVertices=10, max_receptive_field=4, nLevels=2,
                  nChanels=10, nFeatures=4, nDepth=5, seed=7)
    l0 = m.getLoss(graphs, targets)
    for _ in range(150):
        _, l1 = m.BatchLearn(graphs, targets, 0.005)
    assert l1 < 0.2 * l0, (l0, l1)
    # Predictions should be in the right neighborhood after brief training.
    preds = m.Threaded_Predict(graphs)
    assert np.abs(preds - np.asarray(targets)).mean() < 1.5


def test_smp_feature_permutation_invariance(rng):
    """tests/test_graph_permutation_invariant.cpp:143-167: graph-level
    Feature() must be invariant to vertex relabeling."""
    n = 8
    adj = (rng.random((n, n)) < 0.4).astype(int)
    adj = np.triu(adj, 1); adj = adj + adj.T
    feats = np.eye(4)[rng.integers(0, 4, size=n)]
    g = DenseGraph.from_edges(n, 4, np.argwhere(np.triu(adj)), feats)

    m = SMP_omega(max_nVertices=n, max_receptive_field=4, nLevels=2,
                  nChanels=6, nFeatures=4, nDepth=3, seed=3)
    f0 = m.Feature(g)

    for trial in range(3):
        perm = rng.permutation(n)
        gp = g.permuted(perm)
        fp = m.Feature(gp)
        l1_gap = np.abs(f0 - fp).sum()
        assert l1_gap < 1e-3, (trial, l1_gap)


def test_smp_save_load_roundtrip(tmp_path, molecules):
    graphs, targets = molecules
    m = SMP_omega(max_nVertices=10, max_receptive_field=4, nLevels=2,
                  nChanels=5, nFeatures=4, nDepth=2, seed=1)
    p0 = m.Predict(graphs[0])
    fn = str(tmp_path / "smp_omega.dat")
    m.save_model(fn)

    m2 = SMP_omega(max_nVertices=10, max_receptive_field=4, nLevels=2,
                   nChanels=5, nFeatures=4, nDepth=2, seed=99)
    assert abs(m2.Predict(graphs[0]) - p0) > 1e-9  # different init
    m2.load_model(fn)
    assert abs(m2.Predict(graphs[0]) - p0) < 1e-6


@pytest.mark.parametrize("ctor,kwargs", [
    (SMP_beta, dict(max_nVertices=6, nLevels=1, nChanels=4, nFeatures=4,
                    nDepth=2)),
    (SMP_gamma, dict(max_nVertices=6, max_receptive_field=3, nLevels=1,
                     nChanels=4, nFeatures=4, nDepth=2)),
    (SMP_2D_ver6, dict(max_nVertices=6, max_receptive_field=3, nLevels=1,
                       nChanels=4, nFeatures=4, nDepth=2)),
    (SMP_2D_ver7, dict(max_nVertices=6, max_receptive_field=3, nLevels=1,
                       nChanels=4, nFeatures=4, nDepth=2)),
])
def test_smp_variants_train_step(ctor, kwargs, molecules):
    """Every contraction variant converges to a fraction of its initial
    loss (same standard as the flagship convergence test)."""
    graphs, targets = molecules
    m = ctor(**kwargs)
    lb, _ = m.BatchLearn(graphs, targets, 0.003)
    for _ in range(120):
        _, la = m.BatchLearn(graphs, targets, 0.003)
    assert np.isfinite(la)
    assert la < 0.2 * lb, (lb, la)


def test_smp_physics_variant_runs():
    g = molecule("H2O")
    g.coulomb[:3, :3] = np.array([[8.0, 1.0, 1.0],
                                  [1.0, 0.5, 0.3],
                                  [1.0, 0.3, 0.5]])
    m = SMP_omega_physics(max_nVertices=4, max_receptive_field=3, nLevels=1,
                          nChanels=4, nFeatures=4)
    lb, la = m.BatchLearn([g], [3.0], 0.01)
    assert np.isfinite(la)


def test_smp_classification_head(molecules):
    graphs, _ = molecules
    labels = [0, 1, 2, 0]  # arbitrary classes
    cfg = SMP2DConfig(max_nVertices=10, max_receptive_field=4, nLevels=1,
                      nChanels=6, nFeatures=4, nDepth=2, contraction=18,
                      nClasses=3)
    m = SMP2D(cfg, seed=0)
    lb = m.getLoss(graphs, labels)
    for _ in range(60):
        _, la = m.BatchLearn(graphs, labels, 0.01)
    assert la < lb
    scores, _ = m._jit_forward(m.params, m._stack([graphs[1]]))
    assert np.asarray(scores).shape == (1, 3)


def test_smp_backtracking_learn(molecules):
    graphs, targets = molecules
    m = SMP_omega(max_nVertices=10, max_receptive_field=4, nLevels=1,
                  nChanels=4, nFeatures=4, nDepth=2, seed=5)
    l0, l1 = m.BatchLearn(graphs, targets, 0.1, nIterations=10)
    assert l1 <= l0  # backtracking never ends worse than it started


def test_smp_batch_padding_consistency(molecules):
    """A molecule's loss must not depend on which batch it sits in (padding
    exactness)."""
    graphs, targets = molecules
    m = SMP_omega(max_nVertices=10, max_receptive_field=4, nLevels=2,
                  nChanels=5, nFeatures=4, nDepth=3, seed=11)
    single = m.getLoss([graphs[2]], [targets[2]])
    total = m.getLoss(graphs, targets)
    others = m.getLoss([g for i, g in enumerate(graphs) if i != 2],
                       [t for i, t in enumerate(targets) if i != 2])
    np.testing.assert_allclose(total, single + others, rtol=1e-5)


def test_bfloat16_training(molecules):
    """bfloat16 state/params: training must still converge on the toy
    set."""
    graphs, targets = molecules
    cfg = SMP2DConfig(max_nVertices=10, max_receptive_field=4, nLevels=2,
                      nChanels=8, nFeatures=4, nDepth=3, dtype="bfloat16")
    m = SMP2D(cfg, seed=7)
    l0 = m.getLoss(graphs, targets)
    for _ in range(80):
        _, l1 = m.BatchLearn(graphs, targets, 0.005)
    assert l1 < 0.2 * l0, (l0, l1)
