"""First-order SMP model tests (SMP_1D / SMP_theta / Unrestricted)."""

import numpy as np
import pytest
import jax.numpy as jnp

from graphflow_tpu.core.graph import DenseGraph
from graphflow_tpu.models import (
    SMP_theta, SMP_1D, SMP_1D_classification, Unrestricted_SMP_1D,
    SMP_1D_ver2, SMP_1D_ver3, Unrestricted_SMP_1D_ver2,
)
from tests.molecules import all_molecules


@pytest.fixture(scope="module")
def molecules():
    return all_molecules()


@pytest.mark.parametrize("ctor,kwargs", [
    (SMP_theta, dict(max_nVertices=10, max_receptive_field=4, nLevels=2,
                     nChanels=8, nFeatures=4, nDepth=3)),
    (SMP_1D, dict(max_nVertices=10, nLevels=2, nChanels=8, nFeatures=4,
                  nDepth=3)),
    (Unrestricted_SMP_1D, dict(max_nVertices=10, nLevels=2, nChanels=8,
                               nFeatures=4, nDepth=3)),
    (SMP_1D_ver2, dict(max_nVertices=10, nLevels=2, nChanels=4, nFeatures=4,
                       nDepth=3)),
    (SMP_1D_ver3, dict(max_nVertices=10, nLevels=2, nChanels=4, nFeatures=4,
                       nDepth=3)),
    (Unrestricted_SMP_1D_ver2, dict(max_nVertices=10, nLevels=2, nChanels=4,
                                    nFeatures=4, nDepth=3)),
])
def test_first_order_convergence(ctor, kwargs, molecules):
    graphs, targets = molecules
    m = ctor(**kwargs)
    l0 = m.getLoss(graphs, targets)
    for _ in range(60):
        _, l1 = m.BatchLearn(graphs, targets, 0.003)
    assert l1 < 0.5 * l0, (l0, l1)


def test_theta_permutation_invariance(rng):
    n = 8
    adj = (rng.random((n, n)) < 0.4).astype(int)
    adj = np.triu(adj, 1); adj = adj + adj.T
    feats = np.eye(4)[rng.integers(0, 4, size=n)]
    g = DenseGraph.from_edges(n, 4, np.argwhere(np.triu(adj)), feats)
    m = SMP_theta(max_nVertices=n, max_receptive_field=4, nLevels=2,
                  nChanels=6, nFeatures=4, nDepth=3, seed=3)
    f0 = m.Feature(g)
    for _ in range(3):
        perm = rng.permutation(n)
        fp = m.Feature(g.permuted(perm))
        assert np.abs(f0 - fp).sum() < 1e-3


def test_ver2_ver3_channel_growth(molecules):
    """ver2/ver3 double channels per level (SMP_1D_ver2.h:131); ver3 adds
    per-level K_eye/K_one channel mixers (SMP_1D_ver3.h:142-145)."""
    m2 = SMP_1D_ver2(max_nVertices=10, nLevels=2, nChanels=4, nFeatures=4,
                     nDepth=2)
    assert m2.params["W"].shape == (16,)
    assert m2.params["levels"][1]["b"].shape[1:] == (16,)
    assert "K_eye" not in m2.params["levels"][0]
    m3 = SMP_1D_ver3(max_nVertices=10, nLevels=2, nChanels=4, nFeatures=4,
                     nDepth=2)
    assert m3.params["levels"][0]["K_eye"].shape == (4, 4)
    assert m3.params["levels"][1]["K_one"].shape == (8, 8)
    mu = Unrestricted_SMP_1D_ver2(max_nVertices=10, nLevels=2, nChanels=4,
                                  nFeatures=4, nDepth=2)
    assert mu.params["W"].shape == (16,)
    assert "Wf1" in mu.params["levels"][0]


def test_classification_variant(molecules):
    graphs, _ = molecules
    labels = [0, 1, 1, 0]
    m = SMP_1D_classification(max_nVertices=10, nLevels=1, nChanels=6,
                              nFeatures=4, nDepth=2, nClasses=2)
    lb = m.getLoss(graphs, labels)
    for _ in range(40):
        _, la = m.BatchLearn(graphs, labels, 0.01)
    assert la < lb


def test_per_size_parameters_are_used(molecules):
    """Distinct |phi| sizes must read distinct filter parameters: zeroing the
    size-s slot changes only graphs containing a size-s receptive field."""
    graphs, targets = molecules
    m = SMP_theta(max_nVertices=10, max_receptive_field=4, nLevels=1,
                  nChanels=4, nFeatures=4, nDepth=2, seed=0)
    # H2O level-1 sizes: phi(O) = {O,H,H} (3), phi(H) = {O,H} (2);
    # no size-4 receptive field exists.
    h2o = graphs[2]
    base = m.Predict(h2o)
    lam = np.asarray(m.params["levels"][0]["lambda1"]).copy()
    lam[4] += 100.0  # absent size -> must not affect prediction
    p2 = {**m.params, "levels": [
        {**m.params["levels"][0], "lambda1": jnp.asarray(lam)}]}
    m.params = p2
    assert abs(m.Predict(h2o) - base) < 1e-6
    lam2 = lam.copy(); lam2[3] += 100.0  # present size -> must affect it
    m.params = {**p2, "levels": [
        {**p2["levels"][0], "lambda1": jnp.asarray(lam2)}]}
    assert abs(m.Predict(h2o) - base) > 1e-3


def test_save_load_roundtrip(tmp_path, molecules):
    graphs, _ = molecules
    m = SMP_theta(max_nVertices=10, max_receptive_field=4, nLevels=2,
                  nChanels=5, nFeatures=4, nDepth=2, seed=1)
    p0 = m.Predict(graphs[3])
    fn = str(tmp_path / "theta.dat")
    m.save_model(fn)
    m2 = SMP_theta(max_nVertices=10, max_receptive_field=4, nLevels=2,
                   nChanels=5, nFeatures=4, nDepth=2, seed=9)
    m2.load_model(fn)
    assert abs(m2.Predict(graphs[3]) - p0) < 1e-6


def test_sparse_aggregation_matches_dense():
    """SMP1DConfig.sparse_max_degree routes the 1-hop sum through the ELL
    flat-gather; every level state must equal the
    id-space one-hot-matmul path exactly (same sums, f32 accumulation)."""
    import dataclasses
    import numpy as np
    import jax
    from graphflow_tpu.core import prep, batching
    from graphflow_tpu.core.graph import DenseGraph
    from graphflow_tpu.models.smp1d import (SMP1DConfig, init_smp1d_params,
                                            smp1d_states)

    r = np.random.default_rng(11)
    n, V = 9, 10
    edges = [(u, u + 1) for u in range(n - 1)] + [(0, 4), (2, 7)]
    feats = np.zeros((n, 4))
    feats[np.arange(n), r.integers(0, 4, n)] = 1.0
    g = DenseGraph.from_edges(n, 4, edges, feats)

    cfg_d = SMP1DConfig(max_nVertices=V, max_receptive_field=5, nLevels=2,
                        nChanels=6, nFeatures=4, nDepth=2, filter="theta")
    cfg_s = dataclasses.replace(cfg_d, sparse_max_degree=6)
    params = init_smp1d_params(jax.random.PRNGKey(0), cfg_d)

    def run(cfg):
        pg = prep.prepare_graph(g, 2, V, 5, 2,
                                fo_degree=cfg.sparse_max_degree)
        b = batching.stack_graphs([pg])
        one = jax.tree_util.tree_map(lambda x: x[0], b)
        return smp1d_states(params, one, cfg)

    dense = run(cfg_d)
    sparse = run(cfg_s)
    for l, (a, s) in enumerate(zip(dense, sparse)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(s), rtol=1e-6,
                                   atol=1e-7, err_msg=f"level {l}")
