// WHOLE-MODEL ground-truth dumps, part 2 (round 4): GCN_1D, GRU_GCN_1D,
// NeuralFingerprint and SMP_omega_pairgraphs — the remaining flagship
// families pinned against the ACTUAL reference binary.  Same pattern as tools/parity_model_reference.cpp:
// deterministic molecule from a shared LCG, weights LOADED FROM FILE in the
// model's registration order, one forward(), dump every intermediate.
//
// This file is original harness code that #includes the read-only reference
// headers (a measurement of the reference, not part of the framework).
//
// Build: g++ -O2 -std=c++11 -pthread -I/root/reference \
//          tools/parity_model_reference2.cpp -o /tmp/graphflow_parity_model2
// Usage:
//   graphflow_parity_model2 gcn1d n V L H nFeat nDepth R seed weights.txt
//   graphflow_parity_model2 gru   n V L H nFeat nDepth R seed weights.txt
//   graphflow_parity_model2 nf    n V L H nFeat seed weights.txt
//   graphflow_parity_model2 omegapair n1 n2 V1 V2 rf L C nF1 nF2 seed weights.txt
//
// Output (whitespace doubles after "#" header lines):
//   gcn1d/nf:  per level l=0..L, per vertex: hidden (H values);
//              then final_feature (H), predict (1)
//   gru:       per level l=0..L, per vertex: hidden (H);
//              then per vertex: vertex_feature (H); graph_feature (H);
//              predict (1)
//   omegapair: per level l=0..L: level_feature_1 (C) then level_feature_2
//              (C); then graph_feature (2(L+1)C), hidden_relu_1,
//              hidden_relu_2, predict (1)

#include <cstdio>
#include <cstdlib>
#include <cstring>

// The reference headers define file-scope globals (e.g. `const int INF`
// in both GCN_1D.h and GRU_GCN_1D.h), so only ONE model header can live in
// a translation unit: build one binary per kind with -DPARITY_KIND_<KIND>.
#include "GraphFlow/DenseGraph.h"
#if defined(PARITY_KIND_GCN1D)
#include "GraphFlow/GCN_1D.h"
#define GCN_MODEL GCN_1D
#elif defined(PARITY_KIND_GCN2D)
#include "GraphFlow/GCN_2D.h"
#define GCN_MODEL GCN_2D
#elif defined(PARITY_KIND_GCN3D)
#include "GraphFlow/GCN_3D.h"
#define GCN_MODEL GCN_3D
#elif defined(PARITY_KIND_GRU)
#include "GraphFlow/GRU_GCN_1D.h"
#elif defined(PARITY_KIND_NF)
#include "GraphFlow/NeuralFingerprint.h"
#elif defined(PARITY_KIND_OMEGAPAIR)
#include "GraphFlow/SMP_omega_pairgraphs.h"
#elif defined(PARITY_KIND_SMP2D)
#include "GraphFlow/SMP_2D.h"
#define SMP2D_MODEL SMP_2D
#elif defined(PARITY_KIND_SMP2DVER4)
#include "GraphFlow/SMP_2D_ver4.h"
#define SMP2D_MODEL SMP_2D_ver4
#else
#error "define one PARITY_KIND_*"
#endif

static double next_value(unsigned long long &s) {
    // Same LCG as tools/parity_model_reference.cpp.
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

static void dump(Vector *v) {
    for (int i = 0; i < v->size; ++i) printf("%.17g ", v->value[i]);
    printf("\n");
}

static void dump_grad(Vector *v) {
    for (int i = 0; i < v->size; ++i) printf("%.17g ", v->gradient[i]);
    printf("\n");
}

int main(int argc, char **argv) {
    if (argc < 2) { fprintf(stderr, "usage: see header\n"); return 1; }
    const char *kind = argv[1];

#if defined(PARITY_KIND_GCN1D) || defined(PARITY_KIND_GCN2D) || \
    defined(PARITY_KIND_GCN3D) || defined(PARITY_KIND_GRU)
    if (!strncmp(kind, "gcn", 3) || !strcmp(kind, "gru")) {
        int n = atoi(argv[2]), V = atoi(argv[3]), L = atoi(argv[4]);
        int H = atoi(argv[5]), nFeat = atoi(argv[6]), nDepth = atoi(argv[7]);
        int R = atoi(argv[8]);
        unsigned long long seed = (unsigned long long)atoll(argv[9]);
        const char *weights = argv[10];
        DenseGraph *mol = make_molecule(n, nFeat, seed);
        printf("# kind %s n %d V %d L %d H %d\n", kind, n, V, L, H);

#if defined(GCN_MODEL)
        if (!strncmp(kind, "gcn", 3)) {
            GCN_MODEL *model = new GCN_MODEL(L, V, nFeat, H, nDepth, R, 0.9);
            model->load_model(weights);
            model->complete_computation_graph(mol);
            model->graph->forward();
            for (int l = 0; l <= L; ++l)
                for (int v = 0; v < n; ++v)
                    dump(model->level[l]->hidden[v]);
            dump(model->final_feature);
            printf("%.17g\n", model->predict->value[0]);
            if (argc > 11 && !strcmp(argv[11], "grad")) {
                // GRADIENT PARITY: d(0.5 (predict - 3.5)^2)/d(params) in
                // registration order (per level W1(,W2); W) — pins the
                // RisiLayer1D/2D/3D, KMax and (diagonal) Softmax
                // backwards.
                model->target->value[0] = 3.5;
                model->graph->forward();
                model->graph->backward();
                for (size_t i = 0; i < model->sgd->params.size(); ++i)
                    dump_grad(model->sgd->params[i]);
            }
        }
#else
        {
            GRU_GCN_1D *model = new GRU_GCN_1D(L, V, nFeat, H, nDepth, R, 0.9);
            model->load_model(weights);
            model->complete_computation_graph(mol);
            model->graph->forward();
            for (int l = 0; l <= L; ++l)
                for (int v = 0; v < n; ++v)
                    dump(model->level[l]->hidden[v]);
            for (int v = 0; v < n; ++v)
                dump(model->vertex_feature[v]);
            dump(model->graph_feature);
            printf("%.17g\n", model->predict->value[0]);
            if (argc > 11 && !strcmp(argv[11], "grad")) {
                model->target->value[0] = 3.5;
                model->graph->forward();
                model->graph->backward();
                for (size_t i = 0; i < model->sgd->params.size(); ++i)
                    dump_grad(model->sgd->params[i]);
            }
        }
#endif
    }
#elif defined(PARITY_KIND_NF)
    if (!strcmp(kind, "nf")) {
        int n = atoi(argv[2]), V = atoi(argv[3]), L = atoi(argv[4]);
        int H = atoi(argv[5]), nFeat = atoi(argv[6]);
        unsigned long long seed = (unsigned long long)atoll(argv[7]);
        const char *weights = argv[8];
        DenseGraph *mol = make_molecule(n, nFeat, seed);
        printf("# kind nf n %d V %d L %d H %d\n", n, V, L, H);
        NeuralFingerprint *model = new NeuralFingerprint(L, V, nFeat, H, 0.9);
        model->load_model(weights);
        model->complete_computation_graph(mol);
        model->graph->forward();
        for (int l = 0; l <= L; ++l)
            for (int v = 0; v < n; ++v)
                dump(model->level[l]->hidden[v]);
        dump(model->final_feature);
        printf("%.17g\n", model->predict->value[0]);
    }
#elif defined(PARITY_KIND_OMEGAPAIR)
    if (!strcmp(kind, "omegapair")) {
        int n1 = atoi(argv[2]), n2 = atoi(argv[3]);
        int V1 = atoi(argv[4]), V2 = atoi(argv[5]), rf = atoi(argv[6]);
        int L = atoi(argv[7]), C = atoi(argv[8]);
        int nF1 = atoi(argv[9]), nF2 = atoi(argv[10]);
        unsigned long long seed = (unsigned long long)atoll(argv[11]);
        const char *weights = argv[12];
        unsigned long long seed2 = seed + 1000ULL;
        DenseGraph *mol1 = make_molecule(n1, nF1, seed);
        DenseGraph *mol2 = make_molecule(n2, nF2, seed2);
        printf("# kind omegapair n1 %d n2 %d L %d C %d\n", n1, n2, L, C);
        SMP_omega_pairgraphs *model =
            new SMP_omega_pairgraphs(V1, V2, rf, L, C, nF1, nF2);
        model->load_model(weights);
        model->complete_computation_graph(mol1, mol2);
        model->graph->forward();
        // per-tower per-level per-vertex states (size prefix + Tensor3D)
        for (int l = 0; l <= L; ++l) {
            for (int v = 0; v < n1; ++v) {
                int size = (l == 0) ? 1
                    : (int)model->level_1[l]->phi[v].size();
                printf("%d ", size);
                Tensor3D *f = model->level_1[l]->f[v];
                for (int i = 0; i < f->size; ++i)
                    printf("%.17g ", f->value[i]);
                printf("\n");
            }
            for (int v = 0; v < n2; ++v) {
                int size = (l == 0) ? 1
                    : (int)model->level_2[l]->phi[v].size();
                printf("%d ", size);
                Tensor3D *f = model->level_2[l]->f[v];
                for (int i = 0; i < f->size; ++i)
                    printf("%.17g ", f->value[i]);
                printf("\n");
            }
        }
        for (int l = 0; l <= L; ++l) {
            dump(model->level_feature_1[l]);
            dump(model->level_feature_2[l]);
        }
        dump(model->graph_feature);
        dump(model->hidden_relu_1);
        dump(model->hidden_relu_2);
        printf("%.17g\n", model->predict->value[0]);
    }
#elif defined(SMP2D_MODEL)
    // smp2d|smp2dver4 n V L C nFeat nDepth has_WL seed weights.txt
    // Output: per level l=0..L, per vertex: size, then f[v] (f->size
    // Tensor3D row-major values); then graph_feature, predict (1).
    if (!strncmp(kind, "smp2d", 5)) {
        int n = atoi(argv[2]), V = atoi(argv[3]), L = atoi(argv[4]);
        int C = atoi(argv[5]), nFeat = atoi(argv[6]), nDepth = atoi(argv[7]);
        int hasWL = atoi(argv[8]);
        unsigned long long seed = (unsigned long long)atoll(argv[9]);
        const char *weights = argv[10];
        DenseGraph *mol = make_molecule(n, nFeat, seed);
        printf("# kind %s n %d V %d L %d C %d\n", kind, n, V, L, C);
        SMP2D_MODEL *model = new SMP2D_MODEL(V, L, C, nFeat, nDepth, 0.9,
                                             hasWL != 0);
        model->load_model(weights);
        model->complete_computation_graph(mol);
        model->graph->forward();
        for (int l = 0; l <= L; ++l) {
            for (int v = 0; v < n; ++v) {
                int size = (l == 0) ? 1
                    : (int)model->level[l]->phi[v].size();
                printf("%d ", size);
                Tensor3D *f = model->level[l]->f[v];
                for (int i = 0; i < f->size; ++i)
                    printf("%.17g ", f->value[i]);
                printf("\n");
            }
        }
        dump(model->graph_feature);
        printf("%.17g\n", model->predict->value[0]);
    }
#endif
    else {
        fprintf(stderr, "kind %s not built into this binary\n", kind);
        return 1;
    }
    return 0;
}
