// Baseline measurement harness: times the REFERENCE GraphFlow CPU kernels on
// the contraction-bank workload (B vertex neighbourhoods, P, C).
//
// This file is original harness code that #includes the read-only reference
// headers (it is a measurement of the reference, not part of the framework).
//
// Workload: B independent second-order SMP layer applications, each
//   RisiContraction_18 forward (N=P, nChanels=C)  [RisiContraction_18.h:73]
//   + (P*P x 18C) @ (18C x C) channel-reduction MatMul [MatMul.h:48]
// matching bench.py's smp_layer.
//
// Build: g++ -O3 -std=c++11 -I/root/reference tools/bench_reference.cpp -o /tmp/bench_ref
// Run:   /tmp/bench_ref [B] [P] [C]   -> prints JSON {seconds_per_call, ...}

#include <cstdio>
#include <cstdlib>
#include <chrono>
#include <vector>

#include "GraphFlow/Tensor3D.h"
#include "GraphFlow/Matrix.h"
#include "GraphFlow/RisiContraction_18.h"
#include "GraphFlow/MatMul.h"

int main(int argc, char **argv) {
    int B = argc > 1 ? atoi(argv[1]) : 16;
    int P = argc > 2 ? atoi(argv[2]) : 16;
    int C = argc > 3 ? atoi(argv[3]) : 32;

    srand(20170717);

    // One vertex-neighborhood instance, reused B times per "call".
    std::vector<Tensor3D*> tensors;
    for (int a = 0; a < P; ++a) {
        Tensor3D *t = new Tensor3D(P, P, C);
        for (int i = 0; i < t->size; ++i)
            t->value[i] = (double)(rand() % 1000) / 1000.0 - 0.5;
        tensors.push_back(t);
    }
    Matrix *adj = new Matrix(P, P);
    for (int i = 0; i < adj->size; ++i)
        adj->value[i] = (double)(rand() % 1000) / 1000.0;  // all positive

    RisiContraction_18 *contract = new RisiContraction_18(P, C);
    for (int a = 0; a < P; ++a) contract->add_tensor(tensors[a]);
    contract->set_adjacency(adj);

    Matrix *K = new Matrix(18 * C, C);
    for (int i = 0; i < K->size; ++i)
        K->value[i] = (double)(rand() % 1000) / 1000.0 - 0.5;

    // Reshape view of the contraction output as (P*P) x (18C) for the matmul.
    Matrix *reshaped = new Matrix(P * P, 18 * C);
    MatMul *reduce = new MatMul(reshaped, K);

    // Warm up once, then time.
    contract->forward();
    for (int i = 0; i < reshaped->size; ++i)
        reshaped->value[i] = contract->value[i];
    reduce->forward();

    int iters = 3;
    auto t0 = std::chrono::steady_clock::now();
    for (int it = 0; it < iters; ++it) {
        for (int b = 0; b < B; ++b) {
            contract->forward();
            for (int i = 0; i < reshaped->size; ++i)
                reshaped->value[i] = contract->value[i];
            reduce->forward();
        }
    }
    auto t1 = std::chrono::steady_clock::now();
    double secs = std::chrono::duration<double>(t1 - t0).count() / iters;

    // Same analytic FLOP count as bench.py::layer_flops.
    double flops = 2.0 * B * (10.0 * P * P * P * C)
                 + 2.0 * B * (P * P) * (18.0 * C) * C;
    printf("{\"B\": %d, \"P\": %d, \"C\": %d, \"seconds_per_call\": %.6f, "
           "\"gflops\": %.3f}\n", B, P, C, secs, flops / secs / 1e9);
    return 0;
}
