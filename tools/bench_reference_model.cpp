// Whole-model baseline: times the REFERENCE SMP_omega (CPU, double) on one
// BatchLearn over a batch of random molecules plus per-molecule Predict,
// matching tools/bench_model.py's workload.
//
// This file is original harness code that #includes the read-only reference
// headers (a measurement of the reference, not part of the framework).
//
// Workload (reference call stack SMP_omega.h:798 BatchLearn = 3 forwards +
// 1 backward per molecule + Adam step; :924 Predict = 1 forward):
//   nMol random Erdos-Renyi molecules (V vertices, edge prob p, one-hot
//   features), SMP_omega(max_nVertices=V, max_receptive_field, nLevels,
//   nChanels, nFeatures, nDepth).
//
// Build: g++ -O3 -std=c++11 -pthread -I/root/reference \
//          tools/bench_reference_model.cpp -o /tmp/bench_ref_model
// Run:   /tmp/bench_ref_model [nMol] [V] [rf] [L] [C] [threads]
//        -> JSON {batchlearn_seconds, predict_seconds_per_mol, ...}

#include <cstdio>
#include <cstdlib>
#include <chrono>

#include "GraphFlow/DenseGraph.h"
#include "GraphFlow/SMP_omega.h"

int main(int argc, char **argv) {
    int nMol = argc > 1 ? atoi(argv[1]) : 16;
    int V = argc > 2 ? atoi(argv[2]) : 20;
    int rf = argc > 3 ? atoi(argv[3]) : 10;
    int L = argc > 4 ? atoi(argv[4]) : 3;
    int C = argc > 5 ? atoi(argv[5]) : 20;
    int nThreads = argc > 6 ? atoi(argv[6]) : 0;
    const int nFeatures = 4, nDepth = 5;
    const double edge_p = 0.25;

    srand(20170717);

    DenseGraph **mols = new DenseGraph*[nMol];
    double *targets = new double[nMol];
    for (int m = 0; m < nMol; ++m) {
        DenseGraph *g = new DenseGraph(V, nFeatures);
        for (int u = 0; u < V; ++u) {
            g->feature[u][rand() % nFeatures] = 1.0;
            for (int v = u + 1; v < V; ++v) {
                if ((double) rand() / RAND_MAX < edge_p) {
                    g->adj[u][v] = g->adj[v][u] = 1;
                }
            }
        }
        // connect: chain fallback so no isolated vertices
        for (int u = 0; u + 1 < V; ++u) {
            g->adj[u][u + 1] = g->adj[u + 1][u] = 1;
        }
        mols[m] = g;
        targets[m] = (double) V;
    }

    SMP_omega *model = new SMP_omega(V, rf, L, C, nFeatures, nDepth);
    if (nThreads > 1) {
        model->init_multi_threads(nThreads);
    }

    // warm-up: one full pass (allocations, caches)
    if (nThreads > 1) {
        model->Threaded_BatchLearn(nMol, mols, targets, 1e-4);
    } else {
        model->BatchLearn(nMol, mols, targets, 1e-4);
    }

    auto t0 = std::chrono::steady_clock::now();
    if (nThreads > 1) {
        model->Threaded_BatchLearn(nMol, mols, targets, 1e-4);
    } else {
        model->BatchLearn(nMol, mols, targets, 1e-4);
    }
    auto t1 = std::chrono::steady_clock::now();
    double batch_s = std::chrono::duration<double>(t1 - t0).count();

    // Predict timing (single forward per molecule)
    model->Predict(mols[0]);  // warm
    auto t2 = std::chrono::steady_clock::now();
    for (int m = 0; m < nMol; ++m) {
        model->Predict(mols[m]);
    }
    auto t3 = std::chrono::steady_clock::now();
    double pred_s = std::chrono::duration<double>(t3 - t2).count() / nMol;

    printf("{\"nMol\": %d, \"V\": %d, \"rf\": %d, \"L\": %d, \"C\": %d, "
           "\"threads\": %d, \"batchlearn_seconds\": %.6f, "
           "\"predict_seconds_per_mol\": %.6f}\n",
           nMol, V, rf, L, C, nThreads, batch_s, pred_s);
    return 0;
}
