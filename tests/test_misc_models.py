"""Tests for GRU_GCN, GCA, CGCN, LCNN, pairgraphs, LSTM/GRU."""

import numpy as np
import pytest

from graphflow_tpu.models.gru_gcn import GRU_GCN_1D, GRU_GCN_2D, GRU_GCN_3D
from graphflow_tpu.models.gca import GCA_1D, CGCN_1D, CGCN_2D
from graphflow_tpu.models.lcnn import LCNN
from graphflow_tpu.models.rnn import LSTM, GRU
from graphflow_tpu.models.pairgraphs import (
    SMP_omega_pairgraphs, SMP_theta_pairgraphs, SMP_gamma_pairgraphs,
    GCN_1D_Kernel,
)
from tests.molecules import all_molecules


@pytest.fixture(scope="module")
def molecules():
    return all_molecules()


@pytest.mark.parametrize("ctor", [GRU_GCN_1D, GRU_GCN_2D, GRU_GCN_3D])
def test_gru_gcn_converges(ctor, molecules):
    graphs, targets = molecules
    m = ctor(nLevels=2, max_nVertices=10, nFeatures=4, nHiddens=6, nDepth=3,
             max_Radius=2)
    l0 = m.getLoss(graphs, targets)
    for _ in range(80):
        _, l1 = m.BatchLearn(graphs, targets, 0.003)
    assert l1 < 0.5 * l0, (l0, l1)


def test_gca_autoencoder_reconstructs(molecules):
    graphs, _ = molecules
    m = GCA_1D(nLevels=2, max_nVertices=10, nFeatures=4, nHiddens=6,
               nDepth=3, max_Radius=2)
    l0 = m.getLoss(graphs)
    for _ in range(150):
        _, l1 = m.BatchLearn(graphs, learning_rate=0.02)
    assert l1 < l0
    rec = m.Reconstruct(graphs[2])  # H2O
    assert rec.shape == (3, 3)


@pytest.mark.parametrize("ctor,lr", [(CGCN_1D, 0.003), (CGCN_2D, 0.01)])
def test_cgcn_converges(ctor, lr, molecules):
    graphs, targets = molecules
    m = ctor(nLevels=1, max_nVertices=10, nFeatures=4, nDepth=3)
    l0 = m.getLoss(graphs, targets)
    for _ in range(150):
        _, l1 = m.BatchLearn(graphs, targets, lr)
    assert l1 < 0.2 * l0, (l0, l1)


def test_lcnn_converges(molecules):
    graphs, targets = molecules
    m = LCNN(nVertices=10, nFeatures=4, nNeighbors=4, nDepth=3, nChanels1=6,
             nChanels2=6, nDense=8)
    l0 = m.getLoss(graphs, targets)
    for _ in range(80):
        _, l1 = m.BatchLearn(graphs, targets, 0.003)
    assert l1 < 0.1 * l0, (l0, l1)


def test_pairgraphs_similarity(molecules):
    graphs, _ = molecules
    g1s = [graphs[0], graphs[1], graphs[2], graphs[3]]
    g2s = [graphs[1], graphs[2], graphs[3], graphs[0]]
    targets = [abs(a.nVertices - b.nVertices) for a, b in zip(g1s, g2s)]
    for ctor in (SMP_omega_pairgraphs, SMP_theta_pairgraphs):
        m = ctor(10, 10, 4, 1, 6, 4, 4)
        l0 = m.getLoss(g1s, g2s, targets)
        for _ in range(50):
            _, l1 = m.BatchLearn(g1s, g2s, targets, 0.005)
        assert l1 < 0.2 * l0, (ctor.__name__, l0, l1)


def test_pairgraphs_gamma_runs(molecules):
    graphs, _ = molecules
    m = SMP_gamma_pairgraphs(10, 10, 3, 1, 4, 4, 4)
    lb, la = m.BatchLearn([graphs[0]], [graphs[1]], [1.0], 0.01)
    assert np.isfinite(la)


def test_gcn_kernel_two_towers_shared(molecules):
    graphs, _ = molecules
    m = GCN_1D_Kernel(nLevels=2, max_nVertices=10, nFeatures=4, nHiddens=6,
                      nDepth=3, max_Radius=2)
    # kernel values: symmetric-ish target
    g1s = [graphs[0], graphs[2]]
    g2s = [graphs[2], graphs[0]]
    targets = [2.0, 2.0]
    l0 = m.getLoss(g1s, g2s, targets)
    for _ in range(60):
        _, l1 = m.BatchLearn(g1s, g2s, targets, 0.005)
    assert l1 < 0.2 * l0


def _parity_data(T=12, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, 2, size=(T, 1)).astype(float)
    tgt = (np.cumsum(xs[:, 0]).astype(int) % 2)
    return xs, tgt


@pytest.mark.parametrize("ctor", [LSTM, GRU])
def test_sequence_models_learn_parity(ctor):
    """The reference's synthetic parity task (tests/test_LSTM.cpp:37-80)."""
    xs, tgt = _parity_data()
    m = ctor(nFeatures=1, nHiddens=16, nClasses=2, max_nLevels=len(xs))
    first, best = m.Learn(xs, tgt, 200, 0.3)
    assert best < first  # negative log-likelihood improves
    acc = (m.Predict(xs) == tgt).mean()
    assert acc >= 0.6


def test_sequence_save_load(tmp_path):
    xs, tgt = _parity_data()
    m = LSTM(1, 8, 2, len(xs))
    m.Learn(xs, tgt, 20, 0.2)
    p0 = m.Predict(xs)
    fn = str(tmp_path / "lstm.dat")
    m.save_model(fn)
    m2 = LSTM(1, 8, 2, len(xs))
    m2.load_model(fn)
    np.testing.assert_array_equal(m2.Predict(xs), p0)


def test_inspect_dumps_cover_smp1d_and_gcn():
    """ForDebugging-style dumps exist beyond the flagship: shapes match
    the tower schedule."""
    import numpy as np
    from graphflow_tpu.core.graph import DenseGraph
    from graphflow_tpu.models.smp1d import SMP_theta, smp1d_inspect
    from graphflow_tpu.models.gcn import GCN_1D, gcn_inspect

    r = np.random.default_rng(3)
    n = 6
    feats = np.zeros((n, 4)); feats[np.arange(n), r.integers(0, 4, n)] = 1
    g = DenseGraph.from_edges(n, 4, [(u, u + 1) for u in range(n - 1)],
                              feats)
    m1 = SMP_theta(8, 4, 2, 6, 4, 2, seed=0)
    d1 = smp1d_inspect(m1, g)
    assert len(d1["states"]) == 3 and d1["states"][0].shape == (n, 4, 6)
    assert d1["vertex_features"].shape == (n, 6)
    assert d1["graph_feature"].shape == (6,)

    m2 = GCN_1D(2, 8, 4, 5, 2, 1, seed=0)
    d2 = gcn_inspect(m2, g)
    assert len(d2["states"]) == 3 and d2["states"][0].shape == (n, 5)
    assert d2["final_feature"].shape == (5,)
