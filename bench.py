"""Benchmark: the second-order SMP hot path and the 1-hop sparse aggregation
on one NVIDIA GPU, through the model's own code.

At the production level shape (V=256 vertex neighborhoods, P=16, C=32):

  level         one SMP_omega level from state (neighbor gather + 18-case
                bank + channel matmul K + bias + LeakyReLU), forward and
                forward+backward (to state and K), f32 and bf16
  level split   the level's device time by named scope (gather, bank,
                channel_matmul) from a jax.profiler trace
  level bytes   the bytes the level must move (inputs and output only) and
                the bytes the XLA composition moves as it materializes T and
                the 18C concat, with the time each sets at the card's
                published HBM bandwidth
  train step    one SMP_omega-shape train step (forward, backward, Adam) on
                one synthetic graph, L=2
  spmm          ELLPACK SpMM edges/s at V=8192, D=16, H=64
  model         SMP_omega BatchLearn / Threaded_Predict through GraphModel
                (16 molecules, V=20, tools/bench_model.py)

Every time is the median of warm calls that each end in block_until_ready.
The device and the card's power limit are printed first; a default backend
other than a GPU is an error.  The last line of stdout is one JSON object.

Usage: python bench.py
"""

import json
import statistics
import sys
import tempfile
import time

import numpy as np

# Published HBM bandwidth (NVIDIA H100 SXM data sheet), keyed by jax
# device_kind.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def note(msg):
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def warm_median(fn, *args, reps=20):
    """Median seconds of ``reps`` warm calls, each ending in
    block_until_ready (the first call compiles and is not counted)."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


# ----------------------------------------------------------------------
# The level
# ----------------------------------------------------------------------

def level_inputs(V, P, C, dtype, seed=0):
    import jax.numpy as jnp

    rng = np.random.RandomState(seed)
    state = jnp.asarray(rng.randn(V, P, P, C), dtype)
    nbr = jnp.asarray(rng.randint(0, V + 1, size=(V, P)), jnp.int32)
    pos = jnp.asarray(rng.randint(0, P + 1, size=(V, P, P)), jnp.int32)
    radj = jnp.asarray(np.abs(rng.randn(V, P, P)), dtype)
    K = jnp.asarray(rng.randn(18 * C, C) * 0.1, dtype)
    b = jnp.asarray(rng.randn(C) * 0.1, dtype)
    return state, nbr, pos, radj, K, b


def level_fns(V, P, C):
    """(forward, forward+backward) of one 18-case level, jitted."""
    import jax
    import jax.numpy as jnp
    from graphflow_tpu.models.smp2d import SMP2DConfig, smp2d_level

    cfg = SMP2DConfig(max_nVertices=V, max_receptive_field=P, nLevels=1,
                      nChanels=C, nFeatures=4, nDepth=0)

    def fwd(state, nbr, pos, radj, K, b):
        return smp2d_level(cfg, state, nbr, pos, radj, K, b)

    def loss(state, K, nbr, pos, radj, b):
        return jnp.sum(fwd(state, nbr, pos, radj, K, b).astype(jnp.float32)
                       ** 2)

    grad = jax.value_and_grad(loss, argnums=(0, 1))

    def train(state, nbr, pos, radj, K, b):
        return grad(state, K, nbr, pos, radj, b)

    return jax.jit(fwd), jax.jit(train)


def level_bytes(V, P, C, itemsize, n_cases=18):
    """(compulsory, materialized) bytes of one forward level: inputs and
    output only, and that plus writing and reading T [V,P,P,P,C] and the
    [V,P,P,18C] concat once each."""
    io = (V * P * P * C * itemsize            # state
          + V * P * P * itemsize              # radj
          + V * P * 4 + V * P * P * 4         # nbr, pos
          + n_cases * C * C * itemsize        # K
          + V * P * P * C * itemsize)         # output
    T = V * P ** 3 * C * itemsize
    concat = V * P * P * n_cases * C * itemsize
    return io, io + 2 * T + 2 * concat


def level_flops(V, P, C, n_cases=18):
    """Bank (10 shared reductions of P^3 C per vertex) + K matmul."""
    return 2 * V * 10 * P ** 3 * C + 2 * V * P * P * n_cases * C * C


def level_split(fn, args, reps=5):
    """Device seconds per call of gather / bank / channel_matmul / other,
    from a profiler trace of ``reps`` warm calls.  The traced executable
    is compiled without CUDA-graph command buffers, so that every kernel,
    the BLAS ones included, names its HLO instruction."""
    import jax
    from graphflow_tpu.utils.profiling import device_time_by_scope

    compiled = fn.lower(*args).compile(
        compiler_options={"xla_gpu_enable_command_buffer": ""})
    text = compiled.as_text()
    jax.block_until_ready(compiled(*args))
    with tempfile.TemporaryDirectory(prefix="level_trace_") as logdir:
        jax.profiler.start_trace(logdir)
        for _ in range(reps):
            jax.block_until_ready(compiled(*args))
        jax.profiler.stop_trace()
        split = device_time_by_scope(logdir, [text],
                                     ["gather", "bank", "channel_matmul"])
    return {k: v / reps for k, v in split.items()}


# ----------------------------------------------------------------------
# Whole train step, SpMM, whole model
# ----------------------------------------------------------------------

def train_step_seconds(V=256, P=16, C=32, L=2):
    """One SMP_omega-shape train step (forward, backward, Adam) on one
    synthetic prepared graph."""
    import jax
    import jax.numpy as jnp
    from graphflow_tpu.models.smp2d import (SMP2DConfig, init_smp2d_params,
                                            smp2d_forward)
    from graphflow_tpu import optim as optim_lib

    cfg = SMP2DConfig(max_nVertices=V, max_receptive_field=P, nLevels=L,
                      nChanels=C, nFeatures=4, nDepth=0)
    params = init_smp2d_params(jax.random.PRNGKey(0), cfg)
    opt = optim_lib.make_optimizer("adam")
    rng = np.random.RandomState(0)
    g = {
        "wl_feat": jnp.asarray(rng.randn(V, 4), jnp.float32),
        "vmask": jnp.ones((V,), jnp.float32),
        "nbr": jnp.asarray(rng.randint(0, V, (L, V, P)), jnp.int32),
        "pos": jnp.asarray(rng.randint(0, P + 1, (L, V, P, P)), jnp.int32),
        "radj": jnp.abs(jnp.asarray(rng.randn(L, V, P, P), jnp.float32)),
        "smask": jnp.ones((L + 1, V, P, P), jnp.float32),
    }

    @jax.jit
    def step(p, s):
        def loss_fn(p_):
            pred, _ = smp2d_forward(p_, g, cfg)
            return 0.5 * (pred - 3.0) ** 2
        loss, grads = jax.value_and_grad(loss_fn)(p)
        p, s = opt.update(p, s, grads, 1e-4, nBatch=1)
        return p, s, loss

    return warm_median(step, params, opt.init(params))


def spmm_seconds(V=8192, D=16, H=64):
    import jax
    import jax.numpy as jnp
    from graphflow_tpu.ops.sparse import ell_spmm

    rng = np.random.RandomState(0)
    nbr = jnp.asarray(rng.randint(0, V, size=(V, D)), jnp.int32)
    w = jnp.asarray(rng.rand(V, D), jnp.float32)
    h = jnp.asarray(rng.randn(V, H), jnp.float32)
    return warm_median(jax.jit(ell_spmm), nbr, w, h), V * D


def model_seconds(nMol=16, V=20, rf=10, L=3, C=20, reps=5):
    """(BatchLearn seconds, Threaded_Predict seconds per molecule), warm
    medians; BatchLearn and Threaded_Predict return host values, so each
    call ends synchronized."""
    import os
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tools"))
    from bench_model import make_molecules
    from graphflow_tpu.models import SMP_omega

    graphs, targets = make_molecules(nMol, V)
    model = SMP_omega(max_nVertices=V, max_receptive_field=rf, nLevels=L,
                      nChanels=C, nFeatures=4, nDepth=5, seed=0)
    learn = warm_median(lambda: model.BatchLearn(graphs, targets, 1e-4),
                        reps=reps)
    predict = warm_median(lambda: model.Threaded_Predict(graphs), reps=reps)
    return learn, predict / nMol


def main():
    import jax
    from graphflow_tpu.utils.profiling import gpu_card

    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}",
          flush=True)
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; the default backend is "
                         f"{dev.platform}")
    card = gpu_card()
    print(f"card: {card}", flush=True)
    peaks = PEAKS[dev.device_kind]

    V, P, C = 256, 16, 32
    res = {}
    fwd, train = level_fns(V, P, C)
    for dtype in ("float32", "bfloat16"):
        args = level_inputs(V, P, C, dtype)
        tag = "f32" if dtype == "float32" else "bf16"
        note(f"level {tag}")
        t_fwd = warm_median(fwd, *args)
        t_train = warm_median(train, *args)
        io, mat = level_bytes(V, P, C, np.dtype(args[0].dtype).itemsize)
        res[f"level_fwd_ms_{tag}"] = t_fwd * 1e3
        res[f"level_fwd_bwd_ms_{tag}"] = t_train * 1e3
        res[f"level_fwd_bytes_compulsory_{tag}"] = io
        res[f"level_fwd_bytes_materialized_{tag}"] = mat
        res[f"level_fwd_hbm_bound_ms_compulsory_{tag}"] = (
            io / peaks["hbm_bytes_per_s"] * 1e3)
        res[f"level_fwd_hbm_bound_ms_materialized_{tag}"] = (
            mat / peaks["hbm_bytes_per_s"] * 1e3)
        note(f"level split {tag}")
        res[f"level_fwd_split_ms_{tag}"] = {
            k: v * 1e3 for k, v in level_split(fwd, args).items()}
        res[f"level_fwd_bwd_split_ms_{tag}"] = {
            k: v * 1e3 for k, v in level_split(train, args).items()}
    res["level_flops"] = level_flops(V, P, C)
    note("train step")
    res["train_step_ms"] = train_step_seconds(V, P, C) * 1e3
    note("spmm")
    secs, edges = spmm_seconds()
    res["spmm_medges_per_s"] = edges / secs / 1e6
    note("whole model")
    learn, predict = model_seconds()
    res["model_batchlearn_s"] = learn
    res["model_predict_ms_per_mol"] = predict * 1e3
    print(json.dumps({
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "shapes": {"V": V, "P": P, "C": C},
        "results": res,
    }))


if __name__ == "__main__":
    main()
