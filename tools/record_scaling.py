"""Record the scaling/communication artifact.

Produces SCALING_r{N}.json at the repo root with:
  * the partitioned-graph per-level halo-exchange volume table
    (targeted ppermute rows vs the legacy all_gather broadcast) for a
    representative workload, from PartitionPlan.comm_per_level;
  * a virtual-mesh weak-scaling curve of the partitioned forward
    (S = 1 uses the plain forward) — methodology validation only: the
    virtual CPU devices share the host's physical cores, so these are
    NOT ICI numbers (hardware absent; see the "note" field);
  * the DP scaling curve from tools/bench_scaling.py.

Usage: python tools/record_scaling.py [round_number]
"""

import json
import os
import sys
import time

# 8 virtual CPU devices for the mesh sections (must precede jax init).
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np


def partition_section(S_list=(2, 4, 8)):
    import jax
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    import jax.numpy as jnp
    from graphflow_tpu.core import prep, batching
    from graphflow_tpu.models.smp2d import (SMP2DConfig, init_smp2d_params,
                                            smp2d_forward)
    from graphflow_tpu.parallel import mesh as mesh_lib
    from graphflow_tpu.parallel.partition import (
        plan_partition, make_partitioned_forward, shard_inputs)
    from graphflow_tpu.utils.datasets import random_graph

    V, rf, L, C = 48, 6, 3, 8
    g = random_graph(V, 0.15, seed=7)
    cfg = SMP2DConfig(max_nVertices=V, max_receptive_field=rf, nLevels=L,
                      nChanels=C, nFeatures=4, nDepth=3)
    params = init_smp2d_params(jax.random.PRNGKey(0), cfg)
    pg = prep.prepare_graph(g, L, V, rf, cfg.nDepth)

    row_bytes = (rf + 1) * (rf + 1) * C * 4  # padded f32 state row
    out = {"workload": f"SMP_omega-style forward, V={V} rf={rf} L={L} C={C}"}

    def timed(fn, *args, reps=10):
        fn(*args)  # compile
        t0 = time.perf_counter()
        for _ in range(reps):
            r = fn(*args)
        jax.tree_util.tree_map(
            lambda x: x.block_until_ready()
            if hasattr(x, "block_until_ready") else x, r)
        return (time.perf_counter() - t0) / reps

    # single-device baseline
    batch = batching.stack_graphs([pg])
    g0 = jax.tree_util.tree_map(lambda x: x[0], batch)
    fwd1 = jax.jit(lambda p: smp2d_forward(p, g0, cfg))
    t1 = timed(fwd1, params)
    curve = {1: {"ms": round(t1 * 1e3, 3)}}

    comm = None
    for S in S_list:
        plan = plan_partition(pg, S)
        mesh = mesh_lib.make_mesh({"graph": S}, devices=jax.devices("cpu"))
        fwd = make_partitioned_forward(cfg, plan, mesh)
        inputs = shard_inputs(plan)
        tS = timed(fwd, params, inputs)
        curve[S] = {
            "ms": round(tS * 1e3, 3),
            "rows_targeted_static": plan.rows_targeted,
            "rows_allgather_static": plan.rows_allgather,
        }
        if S == S_list[-1]:
            comm = {
                "per_level": plan.comm_per_level,
                "row_bytes": row_bytes,
                "table": plan.comm_table(row_bytes=row_bytes),
            }
    out["forward_curve"] = curve
    out["comm_s8"] = comm
    out["note"] = ("virtual CPU mesh (host cores shared): validates the "
                   "SPMD program, the exchange accounting and the "
                   "methodology, NOT real ICI scaling — multi-chip "
                   "hardware absent in this environment")
    return out


def main():
    rnd = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bench_scaling import measure_dp_scaling

    artifact = {"partition": partition_section()}
    artifact["dp_scaling_graphs_per_s"] = {
        str(k): round(v, 1) for k, v in measure_dp_scaling().items()}

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, f"SCALING_r{rnd:02d}.json")
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1)
    print(json.dumps(artifact, indent=1))
    print(f"\nwritten: {path}")


if __name__ == "__main__":
    main()
