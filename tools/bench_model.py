"""Whole-model benchmark: SMP_omega BatchLearn/Predict through GraphModel.

Mirrors tools/bench_reference_model.cpp (same molecule distribution, model
config, and call semantics: BatchLearn = grad step + loss-after forward;
Predict = one forward).  Wall-clock here INCLUDES host graph prep and
dispatch.

Run: python tools/bench_model.py [nMol] [V] [rf] [L] [C]
"""

import json
import sys
import time

import numpy as np


def make_molecules(nMol, V, nFeatures=4, edge_p=0.25, seed=20170717):
    from graphflow_tpu.core.graph import DenseGraph

    rng = np.random.RandomState(seed)
    graphs, targets = [], []
    for _ in range(nMol):
        g = DenseGraph(V, nFeatures)
        for u in range(V):
            g.feature[u, rng.randint(nFeatures)] = 1.0
        adj = (rng.rand(V, V) < edge_p).astype(np.int32)
        adj = np.triu(adj, 1)
        for u in range(V - 1):
            adj[u, u + 1] = 1
        g.adj = adj + adj.T
        graphs.append(g)
        targets.append(float(V))
    return graphs, targets


def main():
    from graphflow_tpu.models import SMP_omega

    nMol = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    V = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    rf = int(sys.argv[3]) if len(sys.argv) > 3 else 10
    L = int(sys.argv[4]) if len(sys.argv) > 4 else 3
    C = int(sys.argv[5]) if len(sys.argv) > 5 else 20

    graphs, targets = make_molecules(nMol, V)
    model = SMP_omega(max_nVertices=V, max_receptive_field=rf, nLevels=L,
                      nChanels=C, nFeatures=4, nDepth=5, seed=0)

    model.BatchLearn(graphs, targets, 1e-4)          # compile + warm
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        model.BatchLearn(graphs, targets, 1e-4)
        times.append(time.perf_counter() - t0)
    batch_s = float(np.median(times))

    model.Predict(graphs[0])                          # compile + warm
    t0 = time.perf_counter()
    for g in graphs:
        model.Predict(g)
    pred_s = (time.perf_counter() - t0) / nMol

    model.Threaded_Predict(graphs)                    # compile + warm
    t0 = time.perf_counter()
    model.Threaded_Predict(graphs)
    pred_batch_s = (time.perf_counter() - t0) / nMol

    print(json.dumps({
        "nMol": nMol, "V": V, "rf": rf, "L": L, "C": C,
        "batchlearn_seconds": round(batch_s, 6),
        "predict_seconds_per_mol": round(pred_s, 6),
        "predict_batched_seconds_per_mol": round(pred_batch_s, 6),
    }))


if __name__ == "__main__":
    main()
