"""Edge-case robustness: degenerate graphs through every model family."""

import numpy as np
import pytest

from graphflow_tpu.core.graph import DenseGraph
from graphflow_tpu.core import prep
from graphflow_tpu.models import (
    SMP_omega, SMP_theta, SMP_2D, GCN_1D, GCN_MW, NeuralFingerprint,
    GRU_GCN_1D,
)


def _single_vertex():
    g = DenseGraph(1, 4)
    g.feature[0, 0] = 1.0
    return g


def _edgeless():
    g = DenseGraph(3, 4)
    g.feature[:] = np.eye(4)[[0, 1, 2]]
    return g


def _self_loop():
    g = DenseGraph.from_edges(3, 4, [(0, 1)], np.eye(4)[[0, 1, 2]])
    g.adj[2, 2] = 1  # self loop
    return g


def _disconnected():
    return DenseGraph.from_edges(6, 4, [(0, 1), (3, 4)],
                                 np.eye(4)[[0, 1, 2, 3, 0, 1]])


DEGENERATES = [_single_vertex, _edgeless, _self_loop, _disconnected]


@pytest.mark.parametrize("make_graph", DEGENERATES)
def test_prep_handles_degenerate_graphs(make_graph):
    g = make_graph()
    pg = prep.prepare_graph(g, 2, 8, 4, 3)
    assert pg.sizes[0, :g.nVertices].min() == 1
    assert np.isfinite(pg.wl_feat).all()
    # native backend agrees
    pg2 = prep.prepare_graph(g, 2, 8, 4, 3, backend="python")
    np.testing.assert_array_equal(pg.nbr, pg2.nbr)
    np.testing.assert_array_equal(pg.pos, pg2.pos)


@pytest.mark.parametrize("make_graph", DEGENERATES)
@pytest.mark.parametrize("ctor,kwargs", [
    (SMP_omega, dict(max_nVertices=8, max_receptive_field=4, nLevels=2,
                     nChanels=4, nFeatures=4, nDepth=2)),
    (SMP_theta, dict(max_nVertices=8, max_receptive_field=4, nLevels=2,
                     nChanels=4, nFeatures=4, nDepth=2)),
    (SMP_2D, dict(max_nVertices=8, nLevels=1, nChanels=4, nFeatures=4,
                  nDepth=2)),
    (GCN_1D, dict(nLevels=1, max_nVertices=8, nFeatures=4, nHiddens=4,
                  nDepth=2, max_Radius=1)),
    (GCN_MW, dict(nLevels=1, max_nVertices=8, nFeatures=4, nHiddens=4,
                  nDepth=2)),
    (NeuralFingerprint, dict(nLevels=1, max_nVertices=8, nFeatures=4,
                             nHiddens=4)),
    (GRU_GCN_1D, dict(nLevels=1, max_nVertices=8, nFeatures=4, nHiddens=4,
                      nDepth=2, max_Radius=1)),
])
def test_models_finite_on_degenerate_graphs(make_graph, ctor, kwargs):
    g = make_graph()
    m = ctor(**kwargs)
    pred = m.Predict(g)
    assert np.isfinite(pred), (ctor.__name__, pred)
    lb, la = m.BatchLearn([g], [1.0], 1e-3)
    assert np.isfinite(la), (ctor.__name__, la)


def test_nlevels_zero_smp():
    """nLevels=0: just the embedding + head (a valid reference config)."""
    g = _edgeless()
    m = SMP_omega(max_nVertices=4, max_receptive_field=2, nLevels=0,
                  nChanels=4, nFeatures=4, nDepth=1)
    assert np.isfinite(m.Predict(g))


def test_full_graph():
    """Complete graph: maximal receptive fields, heavy capping."""
    n = 6
    edges = [(i, j) for i in range(n) for j in range(i + 1, n)]
    g = DenseGraph.from_edges(n, 4, edges, np.eye(4)[[0, 1, 2, 3, 0, 1]])
    m = SMP_omega(max_nVertices=6, max_receptive_field=3, nLevels=2,
                  nChanels=4, nFeatures=4, nDepth=2)
    assert np.isfinite(m.Predict(g))
    # with cap 3 and a K6, every distance-1 group gets dropped -> phi = {v}
    pg = prep.prepare_graph(g, 1, 6, 3, 2)
    assert (pg.sizes[1, :n] == 1).all()


def test_weighted_adjacency_values():
    """Integer adjacency weights > 1 flow into the reduced adjacency."""
    g = DenseGraph(3, 4)
    g.adj[0, 1] = g.adj[1, 0] = 5
    g.feature[:] = np.eye(4)[[0, 1, 2]]
    pg = prep.prepare_graph(g, 1, 4, 3, 1)
    # the off-diagonal reduced-adjacency entry carries the weight
    s = pg.sizes[1, 0]
    block = pg.radj[0, 0, :s, :s]
    assert block.max() == 5.0


def test_prep_cache_survives_graph_id_reuse():
    """The prepare() memo must key on graph IDENTITY, not id(): collect a
    graph, allocate a different one (CPython routinely reuses the address),
    and check the model computes with the NEW graph's arrays (an
    id()-keyed cache once silently served stale data)."""
    m = SMP_omega(max_nVertices=4, max_receptive_field=2, nLevels=1,
                  nChanels=4, nFeatures=4, nDepth=1)

    def pred_for(feat_row):
        g = DenseGraph.from_edges(3, 4, [(0, 1), (1, 2)],
                                  np.eye(4)[feat_row])
        p = m.Predict(g)
        del g
        return p

    # Hammer allocation so that some DenseGraph lands on a reused id; with
    # the id()-keyed cache the two distinct feature patterns collapsed to
    # one prediction as soon as an id was recycled.
    a = [pred_for([0, 1, 2]) for _ in range(8)]
    b = [pred_for([3, 3, 3]) for _ in range(8)]
    assert len(set(np.round(a, 12))) == 1
    assert len(set(np.round(b, 12))) == 1
    assert abs(a[0] - b[0]) > 1e-9
    # and the weak keying means collected graphs leave the cache
    assert len(m._prep_cache) == 0


def test_ccn1d_pair_driver():
    """CCN_1D is the pair-of-graphs driver (CCN_1D.h:658,874,1060) with the
    reference's ceil(C*decay) channel schedule and 16-channel floor."""
    from graphflow_tpu.models import CCN_1D

    g1 = DenseGraph.from_edges(3, 4, [(0, 1), (1, 2)], np.eye(4)[[0, 1, 2]])
    g2 = DenseGraph.from_edges(4, 4, [(0, 1), (1, 2), (2, 3)],
                               np.eye(4)[[0, 1, 2, 3]])
    m = CCN_1D(4, 4, 2, nLevels=1, nChanels=16, nFeatures_1=4,
               nFeatures_2=4, nChanels_decay=0.5)
    # ceil(16 * 0.5) = 8 -> floored at the reference's 16-channel minimum
    assert m.cfg1.channel_schedule == (16, 16)
    l0, l1 = m.BatchLearn([g1], [g2], [1.0], 0.05)
    assert np.isfinite(l0) and np.isfinite(l1)
    assert np.isfinite(m.Predict(g1, g2))
