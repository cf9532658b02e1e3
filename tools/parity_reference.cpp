// Ground-truth dump harness: runs the REFERENCE GraphFlow kernels on
// deterministic inputs and prints the outputs, so this framework's
// kernels can be compared against the actual reference binary (not a
// re-implementation of it).  Original harness code; #includes the read-only
// reference headers.
//
// Build: g++ -O2 -std=c++11 -I/root/reference tools/parity_reference.cpp -o parity_ref
// Usage: parity_ref risi18 <N> <C> <seed>   -> prints T, A, forward output
//        parity_ref risi4  <N> <C> <seed>
//        parity_ref risi10 <N> <C> <seed>
//        parity_ref risi50 <N> <C> <seed>
// Output format: whitespace-separated doubles: first T (N*N*N*C values,
// Tensor3D row-major per stacked tensor), then A (N*N), then Y.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "GraphFlow/Tensor3D.h"
#include "GraphFlow/Matrix.h"
#include "GraphFlow/RisiContraction_4.h"
#include "GraphFlow/RisiContraction_10.h"
#include "GraphFlow/RisiContraction_18.h"
#include "GraphFlow/RisiContraction_50.h"

static double next_value(unsigned long long &s) {
    // Deterministic LCG so Python can reproduce the inputs exactly.
    s = s * 6364136223846793005ULL + 1442695040888963407ULL;
    return ((double)((s >> 33) & 0x7FFFFFFF) / (double)0x7FFFFFFF) - 0.5;
}

int main(int argc, char **argv) {
    if (argc < 5) { fprintf(stderr, "usage: %s kind N C seed\n", argv[0]); return 1; }
    const char *kind = argv[1];
    int N = atoi(argv[2]), C = atoi(argv[3]);
    unsigned long long seed = (unsigned long long)atoll(argv[4]);

    std::vector<Tensor3D*> tensors;
    for (int a = 0; a < N; ++a) {
        Tensor3D *t = new Tensor3D(N, N, C);
        for (int i = 0; i < t->size; ++i) t->value[i] = next_value(seed);
        tensors.push_back(t);
    }
    Matrix *adj = new Matrix(N, N);
    for (int i = 0; i < adj->size; ++i) adj->value[i] = next_value(seed);

    for (int a = 0; a < N; ++a)
        for (int i = 0; i < tensors[a]->size; ++i)
            printf("%.17g ", tensors[a]->value[i]);
    for (int i = 0; i < adj->size; ++i) printf("%.17g ", adj->value[i]);

    if (!strcmp(kind, "risi18")) {
        RisiContraction_18 *c = new RisiContraction_18(N, C);
        for (int a = 0; a < N; ++a) c->add_tensor(tensors[a]);
        c->set_adjacency(adj);
        c->forward();
        for (int i = 0; i < c->size; ++i) printf("%.17g ", c->value[i]);
    } else if (!strcmp(kind, "risi50")) {
        RisiContraction_50 *c = new RisiContraction_50(N, C);
        for (int a = 0; a < N; ++a) c->add_tensor(tensors[a]);
        c->set_adjacency(adj);
        c->forward();
        for (int i = 0; i < c->size; ++i) printf("%.17g ", c->value[i]);
    } else if (!strcmp(kind, "risi10")) {
        RisiContraction_10 *c = new RisiContraction_10(N, C);
        for (int a = 0; a < N; ++a) c->add_tensor(tensors[a]);
        c->set_adjacency(adj);
        c->forward();
        for (int i = 0; i < c->size; ++i) printf("%.17g ", c->value[i]);
    } else if (!strcmp(kind, "risi4")) {
        RisiContraction_4 *c = new RisiContraction_4(N, C);
        c->setParameter(N, C);
        for (int a = 0; a < N; ++a) c->add_tensor(tensors[a]);
        c->forward();
        for (int i = 0; i < c->size; ++i) printf("%.17g ", c->value[i]);
    } else {
        fprintf(stderr, "unknown kind %s\n", kind);
        return 1;
    }
    printf("\n");
    return 0;
}
