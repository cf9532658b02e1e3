// WHOLE-MODEL ground-truth dumps, part 3 (round 5): the families pinned
// against the compiled reference binary — CCN_1D,
// the steerable leftovers (SMP_2D_ver2/ver5, Unrestricted_SMP_2D(+ver2)),
// SMP_1D, LCNN, GCA_1D, the physics/Coulomb input path and the
// GCN_*_Distance channel.  Same pattern as tools/parity_model_reference2.cpp:
// deterministic molecule from a shared LCG, weights LOADED FROM FILE in the
// model's registration order, one forward(), dump every intermediate.
//
// This file is original harness code that #includes the read-only reference
// headers (a measurement of the reference, not part of the framework).
//
// Build: g++ -O2 -std=c++11 -pthread -I/root/reference \
//          -DPARITY_KIND_<KIND> tools/parity_model_reference3.cpp \
//          -o /tmp/graphflow_parity_<kind>
// Usage:
//   graphflow_parity_ccn1d ccn1d n1 n2 V1 V2 rf L C nF1 nF2 decay seed w.txt

#include <cstdio>
#include <cstdlib>
#include <cstring>

// One reference model header per binary (file-scope globals collide).
#include <fstream>
#include "GraphFlow/DenseGraph.h"
#if defined(PARITY_KIND_CCN1D)
#include "GraphFlow/CCN_1D.h"
#elif defined(PARITY_KIND_SMP2DVER2)
#include "GraphFlow/SMP_2D_ver2.h"
#define SMP2DX_MODEL SMP_2D_ver2
#define SMP2DX_HAS_K 0
#elif defined(PARITY_KIND_SMP2DVER3)
#include "GraphFlow/SMP_2D_ver3.h"
#define SMP2DX_MODEL SMP_2D_ver3
#define SMP2DX_HAS_K 0
#elif defined(PARITY_KIND_SMP2DVER5)
#include "GraphFlow/SMP_2D_ver5.h"
#define SMP2DX_MODEL SMP_2D_ver5
#define SMP2DX_HAS_K 1
#elif defined(PARITY_KIND_USMP2D)
#include "GraphFlow/Unrestricted_SMP_2D.h"
#define SMP2DX_MODEL Unrestricted_SMP_2D
#define SMP2DX_HAS_K 0
#elif defined(PARITY_KIND_USMP2DVER2)
#include "GraphFlow/Unrestricted_SMP_2D_ver2.h"
#define SMP2DX_MODEL Unrestricted_SMP_2D_ver2
#define SMP2DX_HAS_K 0
#elif defined(PARITY_KIND_SMP1D)
#include "GraphFlow/SMP_1D.h"
#define SMP1DX_MODEL SMP_1D
#elif defined(PARITY_KIND_SMP1DVER2)
#include "GraphFlow/SMP_1D_ver2.h"
#define SMP1DX_MODEL SMP_1D_ver2
#elif defined(PARITY_KIND_SMP1DVER3)
#include "GraphFlow/SMP_1D_ver3.h"
#define SMP1DX_MODEL SMP_1D_ver3
#elif defined(PARITY_KIND_USMP1D)
#include "GraphFlow/Unrestricted_SMP_1D.h"
#define SMP1DX_MODEL Unrestricted_SMP_1D
#elif defined(PARITY_KIND_USMP1DVER2)
#include "GraphFlow/Unrestricted_SMP_1D_ver2.h"
#define SMP1DX_MODEL Unrestricted_SMP_1D_ver2
#elif defined(PARITY_KIND_LCNN)
#include "GraphFlow/LCNN.h"
#elif defined(PARITY_KIND_GCA1D)
#include "GraphFlow/GCA_1D.h"
#elif defined(PARITY_KIND_GCN1DD)
#include "GraphFlow/GCN_1D_Distance.h"
#define GCND_MODEL GCN_1D_Distance
#elif defined(PARITY_KIND_GCN2DD)
#include "GraphFlow/GCN_2D_Distance.h"
#define GCND_MODEL GCN_2D_Distance
#elif defined(PARITY_KIND_GCN3DD)
#include "GraphFlow/GCN_3D_Distance.h"
#define GCND_MODEL GCN_3D_Distance
#elif defined(PARITY_KIND_OMEGAGRAD)
#include "GraphFlow/SMP_omega.h"
#elif defined(PARITY_KIND_OMEGAPHYS)
#include "GraphFlow/SMP_omega_physics.h"
#elif defined(PARITY_KIND_THETAPHYS)
#include "GraphFlow/SMP_theta_physics.h"
#elif defined(PARITY_KIND_SIGMAPAIR)
#include "GraphFlow/SMP_sigma_pairgraphs.h"
#elif defined(PARITY_KIND_LSTM)
#include "GraphFlow/LSTM.h"
#define RNN_MODEL LSTM
#elif defined(PARITY_KIND_GRU2)
#include "GraphFlow/GRU.h"
#define RNN_MODEL GRU
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

// Deterministic multi-hot bump (no LCG draw) so per-vertex L1 feature
// norms differ from 1 and the normalization path is actually exercised.
static void multihot(DenseGraph *mol) {
    for (int u = 0; u < mol->nVertices; ++u) {
        mol->feature[u][u % mol->nFeatures] += 0.5;
    }
}

// Deterministic symmetric Coulomb matrix (separate LCG stream).
static void fill_coulomb(DenseGraph *mol, unsigned long long &seed) {
    for (int u = 0; u < mol->nVertices; ++u) {
        for (int v = u; v < mol->nVertices; ++v) {
            double c = next_value(seed) * 4.0;
            mol->coulomb[u][v] = c;
            mol->coulomb[v][u] = c;
        }
    }
}

// Deterministic symmetric geometric distances (zero diagonal).
static void fill_distance(DenseGraph *mol, unsigned long long &seed) {
    for (int u = 0; u < mol->nVertices; ++u) {
        for (int v = u + 1; v < mol->nVertices; ++v) {
            double c = (next_value(seed) + 0.5) * 3.0;
            mol->distance[u][v] = c;
            mol->distance[v][u] = c;
        }
    }
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

#if defined(PARITY_KIND_CCN1D)
    // ccn1d n1 n2 V1 V2 rf L C nF1 nF2 decay seed weights.txt
    // Output: per level l=0..L: per vertex of graph1 (size then the
    // size x C_l matrix f), then per vertex of graph2; per level
    // level_feature_1 then level_feature_2; graph_feature; hidden_relu_1;
    // hidden_relu_2; predict.
    if (!strcmp(kind, "ccn1d")) {
        int n1 = atoi(argv[2]), n2 = atoi(argv[3]);
        int V1 = atoi(argv[4]), V2 = atoi(argv[5]), rf = atoi(argv[6]);
        int L = atoi(argv[7]), C = atoi(argv[8]);
        int nF1 = atoi(argv[9]), nF2 = atoi(argv[10]);
        double decay = atof(argv[11]);
        unsigned long long seed = (unsigned long long)atoll(argv[12]);
        const char *weights = argv[13];
        unsigned long long seed2 = seed + 1000ULL;
        DenseGraph *mol1 = make_molecule(n1, nF1, seed);
        DenseGraph *mol2 = make_molecule(n2, nF2, seed2);
        multihot(mol1);
        multihot(mol2);
        printf("# kind ccn1d n1 %d n2 %d L %d C %d decay %g\n",
               n1, n2, L, C, decay);
        CCN_1D *model = new CCN_1D(V1, V2, rf, L, C, nF1, nF2, decay);
        model->load_model(weights);
        model->complete_computation_graph(mol1, mol2);
        model->graph->forward();
        for (int l = 0; l <= L; ++l) {
            for (int v = 0; v < n1; ++v) {
                int size = (int)model->level_1[l]->phi[v].size();
                printf("%d ", size);
                Matrix *f = model->level_1[l]->f[v];
                for (int i = 0; i < f->size; ++i)
                    printf("%.17g ", f->value[i]);
                printf("\n");
            }
            for (int v = 0; v < n2; ++v) {
                int size = (int)model->level_2[l]->phi[v].size();
                printf("%d ", size);
                Matrix *f = model->level_2[l]->f[v];
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
        if (argc > 14 && !strcmp(argv[14], "grad")) {
            model->target->value[0] = 3.5;
            model->graph->forward();
            model->graph->backward();
            for (size_t i = 0; i < model->sgd->params.size(); ++i)
                dump_grad(model->sgd->params[i]);
        }
    }
#elif defined(SMP2DX_MODEL)
    // smp2dver2|smp2dver3|smp2dver5 n V L C nFeat nDepth hasWL seed w.txt
    // Output: per level l=0..L, per vertex: size, f values; for l>=1 ALSO
    // the pre-filter aggregate (quadratic_plus_adj for ver2/ver5, sum for
    // ver3) so a filter-only divergence can be isolated; then
    // graph_feature, predict.
    if (!strncmp(kind, "smp2dver", 8) || !strncmp(kind, "usmp2d", 6)) {
        int n = atoi(argv[2]), V = atoi(argv[3]), L = atoi(argv[4]);
        int C = atoi(argv[5]), nFeat = atoi(argv[6]), nDepth = atoi(argv[7]);
        int hasWL = atoi(argv[8]);
        unsigned long long seed = (unsigned long long)atoll(argv[9]);
        const char *weights = argv[10];
        DenseGraph *mol = make_molecule(n, nFeat, seed);
        printf("# kind %s n %d V %d L %d C %d\n", kind, n, V, L, C);
        SMP2DX_MODEL *model = new SMP2DX_MODEL(V, L, C, nFeat, nDepth, 0.9,
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
                if (l > 0) {
#if defined(PARITY_KIND_SMP2DVER3)
                    Tensor3D *q = model->level[l]->sum[v];
#else
                    Tensor3D *q = model->level[l]->quadratic_plus_adj[v];
#endif
                    for (int i = 0; i < q->size; ++i)
                        printf("%.17g ", q->value[i]);
                    printf("\n");
                }
            }
        }
        dump(model->graph_feature);
        printf("%.17g\n", model->predict->value[0]);
        if (argc > 11 && !strcmp(argv[11], "grad")) {
            // GRADIENT PARITY through the as-executed backward chain
            // (incl. TensorMul::backward on the reinterpreted 4-D filter
            // for ver2/ver3): d(0.5 (predict - 3.5)^2) / d(params).
            model->target->value[0] = 3.5;
            model->graph->forward();
            model->graph->backward();
            for (size_t i = 0; i < model->sgd->params.size(); ++i)
                dump_grad(model->sgd->params[i]);
        }
    }
#elif defined(SMP1DX_MODEL)
    // smp1d|smp1dver2|smp1dver3|usmp1d|usmp1dver2
    //   n V L C nFeat nDepth hasWL seed w.txt
    // Output: per level l=0..L, per vertex: size, then the size x C_l
    // matrix f; then graph_feature, predict.
    if (!strncmp(kind, "smp1d", 5) || !strncmp(kind, "usmp1d", 6)) {
        int n = atoi(argv[2]), V = atoi(argv[3]), L = atoi(argv[4]);
        int C = atoi(argv[5]), nFeat = atoi(argv[6]), nDepth = atoi(argv[7]);
        int hasWL = atoi(argv[8]);
        unsigned long long seed = (unsigned long long)atoll(argv[9]);
        const char *weights = argv[10];
        DenseGraph *mol = make_molecule(n, nFeat, seed);
        printf("# kind %s n %d V %d L %d C %d\n", kind, n, V, L, C);
        SMP1DX_MODEL *model = new SMP1DX_MODEL(V, L, C, nFeat, nDepth, 0.9,
                                               hasWL != 0);
        model->load_model(weights);
        model->complete_computation_graph(mol);
        model->graph->forward();
        for (int l = 0; l <= L; ++l) {
            for (int v = 0; v < n; ++v) {
                int size = (l == 0) ? 1
                    : (int)model->level[l]->phi[v].size();
                printf("%d ", size);
                Matrix *f = model->level[l]->f[v];
                for (int i = 0; i < f->size; ++i)
                    printf("%.17g ", f->value[i]);
                printf("\n");
            }
        }
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
#elif defined(PARITY_KIND_LCNN)
    // lcnn n V K nDepth C1 C2 nDense nFeat seed w.txt
    // Output: sequence (V*K vertex ids); firstConv; firstReLU; secondConv;
    // denseLayer; predict.  (secondReLU is computed but DEAD in the
    // reference — the dense layer consumes the raw conv, LCNN.h:81.)
    if (!strcmp(kind, "lcnn")) {
        int n = atoi(argv[2]), V = atoi(argv[3]), K = atoi(argv[4]);
        int nDepth = atoi(argv[5]), C1 = atoi(argv[6]), C2 = atoi(argv[7]);
        int nDense = atoi(argv[8]), nFeat = atoi(argv[9]);
        unsigned long long seed = (unsigned long long)atoll(argv[10]);
        const char *weights = argv[11];
        DenseGraph *mol = make_molecule(n, nFeat, seed);
        printf("# kind lcnn n %d V %d K %d\n", n, V, K);
        LCNN *model = new LCNN(V, nFeat, K, nDepth, C1, C2, nDense, 0.9);
        model->load_model(weights);
        model->complete_computation_graph(mol);
        model->target->value[0] = 3.5;
        model->graph->forward();
        dump(model->sequence);
        dump(model->firstConv);
        dump(model->firstReLU);
        dump(model->secondConv);
        dump(model->denseLayer);
        printf("%.17g\n", model->predict->value[0]);
        if (argc > 12 && !strcmp(argv[12], "grad")) {
            // GRADIENT PARITY: d(0.5 (predict - 3.5)^2) / d(params), in
            // registration order (firstFilter, firstBias, secondFilter,
            // secondBias, denseWeight, W).
            model->graph->backward();
            for (size_t i = 0; i < model->sgd->params.size(); ++i)
                dump_grad(model->sgd->params[i]);
        }
    }
#elif defined(PARITY_KIND_GCA1D)
    // gca1d n V L H nFeat nDepth R seed w.txt
    // Output: per level l=0..L, per vertex: hidden (H softmax values);
    // then the LinearGram prediction (n*n) and the reconstruction loss.
    if (!strcmp(kind, "gca1d")) {
        int n = atoi(argv[2]), V = atoi(argv[3]), L = atoi(argv[4]);
        int H = atoi(argv[5]), nFeat = atoi(argv[6]), nDepth = atoi(argv[7]);
        int R = atoi(argv[8]);
        unsigned long long seed = (unsigned long long)atoll(argv[9]);
        const char *weights = argv[10];
        DenseGraph *mol = make_molecule(n, nFeat, seed);
        printf("# kind gca1d n %d V %d L %d H %d\n", n, V, L, H);
        GCA_1D *model = new GCA_1D(L, V, nFeat, H, nDepth, R, 0.9);
        model->load_model(weights);
        model->complete_computation_graph(mol);
        model->graph->forward();
        for (int l = 0; l <= L; ++l)
            for (int v = 0; v < n; ++v)
                dump(model->level[l]->hidden[v]);
        dump(model->predict);
        printf("%.17g\n", model->sql->getLoss());
        if (argc > 11 && !strcmp(argv[11], "grad")) {
            model->graph->backward();
            for (size_t i = 0; i < model->sgd->params.size(); ++i)
                dump_grad(model->sgd->params[i]);
        }
    }
#elif defined(GCND_MODEL)
    // gcn1dd|gcn2dd|gcn3dd n V L H nFeat nDepth R seed w.txt
    // Output: per level per vertex vertex-channel hidden (H); per level per
    // vertex distance-channel hidden (H); final_vertex; final_distance;
    // predict.
    if (!strncmp(kind, "gcn", 3)) {
        int n = atoi(argv[2]), V = atoi(argv[3]), L = atoi(argv[4]);
        int H = atoi(argv[5]), nFeat = atoi(argv[6]), nDepth = atoi(argv[7]);
        int R = atoi(argv[8]);
        unsigned long long dseed = (unsigned long long)atoll(argv[9]) + 555ULL;
        unsigned long long seed = (unsigned long long)atoll(argv[9]);
        const char *weights = argv[10];
        DenseGraph *mol = make_molecule(n, nFeat, seed);
        fill_distance(mol, dseed);
        printf("# kind %s n %d V %d L %d H %d\n", kind, n, V, L, H);
        GCND_MODEL *model = new GCND_MODEL(L, V, nFeat, H, nDepth, R, 0.9);
        model->load_model(weights);
        model->complete_computation_graph(mol);
        model->graph->forward();
        for (int l = 0; l <= L; ++l)
            for (int v = 0; v < n; ++v)
                dump(model->chanel_vertex[l]->hidden[v]);
        for (int l = 0; l <= L; ++l)
            for (int v = 0; v < n; ++v)
                dump(model->chanel_distance[l]->hidden[v]);
        dump(model->final_vertex);
        dump(model->final_distance);
        printf("%.17g\n", model->predict->value[0]);
    }
#elif defined(PARITY_KIND_OMEGAGRAD)
    // omegagrad n V rf L C nFeat nDepth target seed w.txt
    // Output: predict; then d(0.5 (predict - target)^2)/d(params) in
    // registration order (H; per level K, b; W).
    if (!strcmp(kind, "omegagrad")) {
        int n = atoi(argv[2]), V = atoi(argv[3]), rf = atoi(argv[4]);
        int L = atoi(argv[5]), C = atoi(argv[6]), nFeat = atoi(argv[7]);
        int nDepth = atoi(argv[8]);
        double target = atof(argv[9]);
        unsigned long long seed = (unsigned long long)atoll(argv[10]);
        const char *weights = argv[11];
        DenseGraph *mol = make_molecule(n, nFeat, seed);
        printf("# kind omegagrad n %d V %d L %d C %d\n", n, V, L, C);
        SMP_omega *model = new SMP_omega(V, rf, L, C, nFeat, nDepth);
        model->load_model(weights);
        model->complete_computation_graph(mol);
        model->target->value[0] = target;
        model->graph->forward();
        printf("%.17g\n", model->predict->value[0]);
        model->graph->backward();
        for (size_t i = 0; i < model->sgd->params.size(); ++i)
            dump_grad(model->sgd->params[i]);
    }
#elif defined(PARITY_KIND_OMEGAPHYS)
    // omegaphys n V rf L C nFeat use_coulomb seed w.txt
    // Output: per level, per vertex: size, f; per level: level_feature;
    // graph_feature; hidden_activation; predict.
    if (!strcmp(kind, "omegaphys")) {
        int n = atoi(argv[2]), V = atoi(argv[3]), rf = atoi(argv[4]);
        int L = atoi(argv[5]), C = atoi(argv[6]), nFeat = atoi(argv[7]);
        int useC = atoi(argv[8]);
        unsigned long long seed = (unsigned long long)atoll(argv[9]);
        const char *weights = argv[10];
        unsigned long long cseed = seed + 777ULL;   // pre-mutation seed
        DenseGraph *mol = make_molecule(n, nFeat, seed);
        fill_coulomb(mol, cseed);
        printf("# kind omegaphys n %d V %d L %d C %d useC %d\n",
               n, V, L, C, useC);
        SMP_omega_physics *model =
            new SMP_omega_physics(useC != 0, V, rf, L, C, nFeat);
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
        for (int l = 0; l <= L; ++l)
            dump(model->level_feature[l]);
        dump(model->graph_feature);
        dump(model->hidden_activation);
        printf("%.17g\n", model->predict->value[0]);
    }
#elif defined(PARITY_KIND_THETAPHYS)
    // thetaphys n V rf L C nFeat seed w.txt
    if (!strcmp(kind, "thetaphys")) {
        int n = atoi(argv[2]), V = atoi(argv[3]), rf = atoi(argv[4]);
        int L = atoi(argv[5]), C = atoi(argv[6]), nFeat = atoi(argv[7]);
        unsigned long long seed = (unsigned long long)atoll(argv[8]);
        const char *weights = argv[9];
        DenseGraph *mol = make_molecule(n, nFeat, seed);
        printf("# kind thetaphys n %d V %d L %d C %d\n", n, V, L, C);
        SMP_theta_physics *model =
            new SMP_theta_physics(V, rf, L, C, nFeat);
        model->load_model(weights);
        model->complete_computation_graph(mol);
        model->graph->forward();
        for (int l = 0; l <= L; ++l) {
            for (int v = 0; v < n; ++v) {
                int size = (l == 0) ? 1
                    : (int)model->level[l]->phi[v].size();
                printf("%d ", size);
                Matrix *f = model->level[l]->f[v];
                for (int i = 0; i < f->size; ++i)
                    printf("%.17g ", f->value[i]);
                printf("\n");
            }
        }
        for (int l = 0; l <= L; ++l)
            dump(model->level_feature[l]);
        dump(model->graph_feature);
        dump(model->hidden_activation);
        printf("%.17g\n", model->predict->value[0]);
    }
#elif defined(PARITY_KIND_SIGMAPAIR)
    // sigmapair n1 n2 V1 V2 rf L C nF1 nF2 nKept seed w.txt
    // TEST MODE (deterministic): all 18 contraction cases scaled by
    // nKept/18 (RisiContraction_18_dropout.h:466-471).  Output: per-tower
    // per-level per-vertex states; per level level_feature_1/2;
    // graph_feature; hidden_relu_1/2; predict.
    if (!strcmp(kind, "sigmapair")) {
        int n1 = atoi(argv[2]), n2 = atoi(argv[3]);
        int V1 = atoi(argv[4]), V2 = atoi(argv[5]), rf = atoi(argv[6]);
        int L = atoi(argv[7]), C = atoi(argv[8]);
        int nF1 = atoi(argv[9]), nF2 = atoi(argv[10]);
        int nKept = atoi(argv[11]);
        unsigned long long seed = (unsigned long long)atoll(argv[12]);
        const char *weights = argv[13];
        unsigned long long seed2 = seed + 1000ULL;
        DenseGraph *mol1 = make_molecule(n1, nF1, seed);
        DenseGraph *mol2 = make_molecule(n2, nF2, seed2);
        printf("# kind sigmapair n1 %d n2 %d L %d C %d nKept %d\n",
               n1, n2, L, C, nKept);
        SMP_sigma_pairgraphs *model = new SMP_sigma_pairgraphs(
            V1, V2, rf, L, C, nF1, nF2, nKept);
        model->setTestMode();
        model->load_model(weights);
        model->complete_computation_graph(mol1, mol2);
        model->graph->forward();
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
#elif defined(RNN_MODEL)
    // lstm|gru nFeat H nClasses T seed w.txt
    // Output: per step: hidden (H), average_pool (H), softmax (nClasses);
    // then the total getLoss.
    if (!strcmp(kind, "lstm") || !strcmp(kind, "gru")) {
        int nFeat = atoi(argv[2]), H = atoi(argv[3]);
        int nClasses = atoi(argv[4]), T = atoi(argv[5]);
        unsigned long long seed = (unsigned long long)atoll(argv[6]);
        const char *weights = argv[7];
        printf("# kind %s F %d H %d C %d T %d\n", kind, nFeat, H, nClasses,
               T);
        double **xs = new double *[T];
        int *ts = new int[T];
        for (int l = 0; l < T; ++l) {
            xs[l] = new double[nFeat];
            for (int f = 0; f < nFeat; ++f)
                xs[l][f] = next_value(seed);
        }
        for (int l = 0; l < T; ++l) {
            int t = (int)((next_value(seed) + 0.5) * nClasses);
            ts[l] = t >= nClasses ? nClasses - 1 : t;
        }
        RNN_MODEL *model = new RNN_MODEL(nFeat, H, nClasses, T, 0.9);
        model->load_model(weights);
        model->complete_computation_graph(T, xs);
        for (int l = 0; l < T; ++l)
            model->level[l]->target->value[0] = ts[l];
        model->graph->forward();
        for (int l = 0; l < T; ++l) {
            dump(model->level[l]->hidden);
            dump(model->level[l]->average_pool);
            dump(model->level[l]->softmax);
        }
        printf("%.17g\n", model->getLoss(T));
        if (argc > 8 && !strcmp(argv[8], "grad")) {
            model->graph->backward();
            for (size_t i = 0; i < model->sgd->params.size(); ++i)
                dump_grad(model->sgd->params[i]);
        }
    }
#endif
    else {
        fprintf(stderr, "kind %s not built into this binary\n", kind);
        return 1;
    }
    return 0;
}
