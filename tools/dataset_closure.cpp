// Dataset-scale closure run (SURVEY §7 step 9 /
// BASELINE.md "matching downstream accuracy"): train the REFERENCE
// SMP_omega / GCN_1D on a deterministic ~100-molecule set from IDENTICAL
// initial weights as the graphflow_tpu run (tools/dataset_closure.py) and
// dump the per-iteration loss curve + held-out MAE + wall time, so the two
// frameworks' training dynamics can be compared end-to-end — not just
// single-forward activations.
//
// This file is original harness code that #includes the read-only
// reference headers (a measurement of the reference, not framework code).
//
// Build (one binary per kind — reference headers collide at file scope):
//   g++ -O3 -std=c++11 -pthread -I/root/reference -DCLOSURE_OMEGA \
//       tools/dataset_closure.cpp -o /tmp/closure_omega
//   g++ -O3 -std=c++11 -pthread -I/root/reference -DCLOSURE_GCN1D \
//       tools/dataset_closure.cpp -o /tmp/closure_gcn1d
// Usage:
//   closure_omega omega nTrain nTest nLo nHi V rf L C nFeat nDepth iters
//                 lr seed w.txt
//   closure_gcn1d gcn1d nTrain nTest nLo nHi V R  L H nFeat nDepth iters
//                 lr seed w.txt
// Output lines:
//   iter <i> <loss_before> <loss_after>
//   train_seconds <s>
//   test_mae <mae>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <chrono>
#include <fstream>

#include "GraphFlow/DenseGraph.h"
#if defined(CLOSURE_OMEGA)
#include "GraphFlow/SMP_omega.h"
#elif defined(CLOSURE_GCN1D)
#include "GraphFlow/GCN_1D.h"
#else
#error "define CLOSURE_OMEGA or CLOSURE_GCN1D"
#endif

static double next_value(unsigned long long &s) {
    s = s * 6364136223846793005ULL + 1442695040888963407ULL;
    return ((double)((s >> 33) & 0x7FFFFFFF) / (double)0x7FFFFFFF) - 0.5;
}

static DenseGraph *make_molecule(int n, int nFeat, unsigned long long &seed) {
    DenseGraph *mol = new DenseGraph(n, nFeat);
    for (int u = 0; u < n; ++u) {
        int fi = (int)((next_value(seed) + 0.5) * nFeat);
        if (fi >= nFeat) fi = nFeat - 1;
        mol->feature[u][fi] = 1.0;
    }
    for (int u = 0; u < n; ++u) {
        for (int v = u + 1; v < n; ++v) {
            if (next_value(seed) < -0.1) {
                mol->adj[u][v] = mol->adj[v][u] = 1;
            }
        }
    }
    for (int u = 0; u + 1 < n; ++u) {
        mol->adj[u][u + 1] = mol->adj[u + 1][u] = 1;
    }
    return mol;
}

// One LCG stream drives sizes, molecules and targets, in that order per
// molecule — replicated exactly by tools/dataset_closure.py.
static void make_dataset(int nMol, int nLo, int nHi, int nFeat,
                         unsigned long long &seed,
                         DenseGraph **mols, double *targets) {
    for (int m = 0; m < nMol; ++m) {
        int span = nHi - nLo + 1;
        int n = nLo + (int)((next_value(seed) + 0.5) * span);
        if (n > nHi) n = nHi;
        mols[m] = make_molecule(n, nFeat, seed);
        // QM9-style scalar target: size term + noisy per-vertex sum
        targets[m] = (double)n + 2.0 * next_value(seed);
    }
}

int main(int argc, char **argv) {
    if (argc < 16) { fprintf(stderr, "usage: see header\n"); return 1; }
    int nTrain = atoi(argv[2]), nTest = atoi(argv[3]);
    int nLo = atoi(argv[4]), nHi = atoi(argv[5]), V = atoi(argv[6]);
    int P1 = atoi(argv[7]);   // rf (omega) | max_Radius (gcn1d)
    int L = atoi(argv[8]), C = atoi(argv[9]);
    int nFeat = atoi(argv[10]), nDepth = atoi(argv[11]);
    int iters = atoi(argv[12]);
    double lr = atof(argv[13]);
    unsigned long long seed = (unsigned long long)atoll(argv[14]);
    const char *weights = argv[15];

    int nMol = nTrain + nTest;
    DenseGraph **mols = new DenseGraph *[nMol];
    double *targets = new double[nMol];
    make_dataset(nMol, nLo, nHi, nFeat, seed, mols, targets);

#if defined(CLOSURE_OMEGA)
    SMP_omega *model = new SMP_omega(V, P1, L, C, nFeat, nDepth);
#else
    GCN_1D *model = new GCN_1D(L, V, nFeat, C, nDepth, P1, 0.9);
#endif
    model->load_model(weights);

    auto t0 = std::chrono::steady_clock::now();
    for (int it = 0; it < iters; ++it) {
        std::pair<double, double> r =
            model->BatchLearn(nTrain, mols, targets, lr);
        printf("iter %d %.17g %.17g\n", it, r.first, r.second);
        fflush(stdout);
    }
    auto t1 = std::chrono::steady_clock::now();
    double secs = std::chrono::duration<double>(t1 - t0).count();
    printf("train_seconds %.3f\n", secs);

    double mae = 0.0;
    for (int m = nTrain; m < nMol; ++m) {
        double p = model->Predict(mols[m]);
        double d = p - targets[m];
        mae += d < 0 ? -d : d;
    }
    printf("test_mae %.17g\n", mae / nTest);
    return 0;
}
