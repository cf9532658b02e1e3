"""Aggregation throughput (edges/s) + data-parallel scaling efficiency.

BASELINE.json's north-star metrics: edges/s per device for
SpMM-style neighbor aggregation and >= 80% scaling efficiency 1 -> N
devices.  Real multi-chip hardware is not available in this environment, so
the scaling section runs on N virtual CPU devices — validating the SPMD
program and the measurement methodology; absolute edges/s comes from the
accelerator section.

Usage: python tools/bench_scaling.py
"""

import time

import numpy as np


def measure_edges_per_s(device, V=8192, C=256, density=0.01, iters=50):
    """Masked-matmul neighbor aggregation (the GCN_MW inner op) on device."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    adj = (rng.random((V, V)) < density).astype(np.float32)
    n_edges = int(adj.sum())
    with jax.default_device(device):
        A = jnp.asarray(adj)
        H = jnp.asarray(rng.standard_normal((V, C)), jnp.float32)

        def chain(k):
            @jax.jit
            def run(A, H):
                def body(Hc, _):
                    Hc = jnp.tanh(A @ Hc)
                    return Hc, ()
                Hf, _ = jax.lax.scan(body, H, None, length=k)
                return Hf.sum()
            return run

        r1, rk = chain(1), chain(iters + 1)
        float(r1(A, H)); float(rk(A, H))
        t0 = time.perf_counter(); float(r1(A, H))
        t1 = time.perf_counter() - t0
        t0 = time.perf_counter(); float(rk(A, H))
        tk = time.perf_counter() - t0
    per_call = max((tk - t1) / iters, 1e-9)
    return n_edges / per_call, per_call


def measure_dp_scaling(n_list=(1, 2, 4, 8)):
    """DP scaling efficiency of the SMP train step on virtual CPU devices."""
    import jax
    from graphflow_tpu.models import SMP_omega
    from graphflow_tpu import parallel

    cpus = jax.devices("cpu")
    # Pin array creation to CPU: without this every intermediate bounces
    # through the default accelerator.
    jax.config.update("jax_default_device", cpus[0])
    model = SMP_omega(max_nVertices=8, max_receptive_field=3, nLevels=1,
                      nChanels=8, nFeatures=4, nDepth=2, seed=0)
    from graphflow_tpu.utils.datasets import toy_molecules
    graphs, targets = toy_molecules()

    results = {}
    for n in n_list:
        if n > len(cpus):
            continue
        reps = (n * 4) // len(graphs) + 1
        gs, ts = (graphs * reps)[:4 * n], (targets * reps)[:4 * n]
        mesh = parallel.make_mesh({"data": n}, devices=cpus)
        step = parallel.make_dp_train_step(model._loss, model.opt, mesh)
        batch = model._stack(gs, ts)
        batch = parallel.shard_batch(batch, mesh)
        params = parallel.replicate(model.params, mesh)
        state = parallel.replicate(model.opt_state, mesh)
        step(params, state, batch, 1e-3)[2].block_until_ready()
        t0 = time.perf_counter()
        for _ in range(10):
            _, _, loss = step(params, state, batch, 1e-3)
        loss.block_until_ready()
        dt = (time.perf_counter() - t0) / 10
        results[n] = len(gs) / dt  # graphs/s
    return results


def main():
    import jax

    accel = jax.devices()[0]
    eps, per_call = measure_edges_per_s(accel)
    # Edges/s scales with density under the dense-batched formulation.
    print(f"aggregation on {accel.device_kind}: "
          f"{eps/1e9:.2f} Gedges/s ({per_call*1e3:.3f} ms per sweep)")

    results = measure_dp_scaling()
    if 1 in results:
        print("NOTE: the virtual CPU mesh shares the host's physical cores, "
              "so these efficiencies validate the SPMD program + harness, "
              "not real ICI scaling (requires a multi-chip slice):")
        base = results[1]
        for n, thr in sorted(results.items()):
            eff = thr / (n * base) * 100
            print(f"  DP x{n}: {thr:.1f} graphs/s ({eff:.0f}% of linear)")


if __name__ == "__main__":
    main()
