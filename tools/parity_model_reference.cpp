// WHOLE-MODEL ground-truth dump: builds the REFERENCE SMP_omega / SMP_theta
// (compiled from the read-only reference headers) on a deterministic
// molecule with weights LOADED FROM FILE, runs complete_computation_graph +
// forward, and dumps every per-level vertex state, the vertex features, the
// graph feature, and the prediction.  tests/test_model_parity.py rebuilds
// the identical molecule + weights in this framework and compares all
// activations element-wise.
//
// This file is original harness code that #includes the read-only reference
// headers (a measurement of the reference, not part of the framework).
//
// Build: g++ -O2 -std=c++11 -pthread -I/root/reference \
//          tools/parity_model_reference.cpp -o /tmp/graphflow_parity_model
// Usage: graphflow_parity_model (omega|theta) n V rf L C nFeat nDepth seed weights.txt
//   n     actual molecule vertices (n <= V exercises framework padding)
//   V     max_nVertices;  rf  max_receptive_field;  L  nLevels;  C  nChanels
//   weights.txt  whitespace doubles in the model's registration order
//                (SMP_omega.h:289-295 / SMP_theta.h:255-264)
//
// Output (whitespace doubles, after a "# key value" header block):
//   per level l=0..L, per vertex v=0..n-1: size, then the state values
//     (omega: size*size*C Tensor3D row-major = depth-last;
//      theta: size*C Matrix row-major)
//   then per vertex: vertex_feature (C), then graph_feature (C), predict (1)

#include <cstdio>
#include <cstdlib>
#include <cstring>

#include "GraphFlow/DenseGraph.h"
#include "GraphFlow/SMP_omega.h"
#include "GraphFlow/SMP_theta.h"

static double next_value(unsigned long long &s) {
    // Same LCG as tools/parity_reference.cpp so Python reproduces inputs.
    s = s * 6364136223846793005ULL + 1442695040888963407ULL;
    return ((double)((s >> 33) & 0x7FFFFFFF) / (double)0x7FFFFFFF) - 0.5;
}

int main(int argc, char **argv) {
    if (argc < 11) {
        fprintf(stderr,
                "usage: %s (omega|theta) n V rf L C nFeat nDepth seed weights\n",
                argv[0]);
        return 1;
    }
    const char *kind = argv[1];
    int n = atoi(argv[2]), V = atoi(argv[3]), rf = atoi(argv[4]);
    int L = atoi(argv[5]), C = atoi(argv[6]);
    int nFeat = atoi(argv[7]), nDepth = atoi(argv[8]);
    unsigned long long seed = (unsigned long long)atoll(argv[9]);
    const char *weights = argv[10];

    // Deterministic molecule: one-hot feature from the LCG, ER edges
    // (p = 0.4) + a connecting chain.
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

    printf("# kind %s n %d V %d rf %d L %d C %d\n", kind, n, V, rf, L, C);

    if (!strcmp(kind, "omega")) {
        SMP_omega *model = new SMP_omega(V, rf, L, C, nFeat, nDepth);
        model->load_model(weights);
        model->complete_computation_graph(mol);
        model->graph->forward();
        for (int l = 0; l <= L; ++l) {
            for (int v = 0; v < n; ++v) {
                int size = (l == 0) ? 1 : (int)model->level[l]->phi[v].size();
                printf("%d ", size);
                Tensor3D *f = model->level[l]->f[v];
                for (int i = 0; i < f->size; ++i)
                    printf("%.17g ", f->value[i]);
                printf("\n");
            }
        }
        for (int v = 0; v < n; ++v) {
            for (int i = 0; i < model->vertex_feature[v]->size; ++i)
                printf("%.17g ", model->vertex_feature[v]->value[i]);
            printf("\n");
        }
        for (int i = 0; i < model->graph_feature->size; ++i)
            printf("%.17g ", model->graph_feature->value[i]);
        printf("\n%.17g\n", model->predict->value[0]);
    } else if (!strcmp(kind, "theta")) {
        SMP_theta *model = new SMP_theta(V, rf, L, C, nFeat, nDepth);
        model->load_model(weights);
        model->complete_computation_graph(mol);
        model->graph->forward();
        for (int l = 0; l <= L; ++l) {
            for (int v = 0; v < n; ++v) {
                int size = (l == 0) ? 1 : (int)model->level[l]->phi[v].size();
                printf("%d ", size);
                Matrix *f = model->level[l]->f[v];
                for (int i = 0; i < f->size; ++i)
                    printf("%.17g ", f->value[i]);
                printf("\n");
            }
        }
        for (int v = 0; v < n; ++v) {
            for (int i = 0; i < model->vertex_feature[v]->size; ++i)
                printf("%.17g ", model->vertex_feature[v]->value[i]);
            printf("\n");
        }
        for (int i = 0; i < model->graph_feature->size; ++i)
            printf("%.17g ", model->graph_feature->value[i]);
        printf("\n%.17g\n", model->predict->value[0]);
    } else {
        fprintf(stderr, "unknown kind %s\n", kind);
        return 1;
    }
    return 0;
}
