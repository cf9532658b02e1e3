"""Smoke run of the main path on one NVIDIA GPU.

Drives SMP_omega (second-order steerable message passing: the 18-case
contraction bank with Adam) at the production level shape through the
GraphModel API, on 8 seeded molecule-sparse random graphs of 256 vertices
prepared by core/prep, in one process:

  device     platform, device_kind, count; the card's name and power limit
  gather     T from the neighbor gather at full width vs a NumPy fancy-index
             gather, f32 and bf16: bit-exact
  train      4 x BatchLearn (the first compiles): loss finite and strictly
             falling; median of the 3 warm calls
  predict    Threaded_Predict and Feature in f32; Threaded_Predict with the
             same weights in bfloat16: finite; medians of 3 warm calls
  reference  each result vs the plain float32 path at matmul precision
             "highest", same weights and batch, on the card; and that path
             on one graph vs the CPU backend

Every observed error is printed beside its limit, with compile seconds per
jitted function and peak device memory.  Any failed check raises, so the
script exits non-zero; so it does when JAX's default backend is not a GPU.
The last line of stdout is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.

Usage:  python chip_smoke.py          # one GPU, the phases above
        python chip_smoke.py --four   # only the multi-device path on 4 GPUs
                                      # (__graft_entry__.dryrun_multichip at
                                      # full width) and its comparisons
"""

import argparse
import json
import statistics
import sys
import time

import numpy as np

# SMP_omega at the production level shape (bench.py, README).
FULL = dict(max_nVertices=256, max_receptive_field=16, nLevels=2,
            nChanels=32, nFeatures=4, nDepth=5)
N_GRAPHS = 8
# The reference-faithful nBatch Adam starts uncorrected (~3.16 lr per
# weight per step), and the graph feature sums 256 vertices: a larger rate
# overshoots in the first steps (at V=64 on the CPU, 1e-6 still falls
# strictly, 1e-5 does not).
LEARNING_RATE = 1e-7

# Limits on max|got - ref| / max|ref| (README "Testing and benchmarks").
TOL_F32 = 1e-2       # TF32 may run the bank's and K's f32 matmuls
TOL_GRAD = 2e-2      # the same, through the backward pass
TOL_BF16 = 5e-2      # bf16 keeps 8 mantissa bits
TOL_CPU = 1e-4       # "highest" on the card vs the CPU backend

def log(msg):
    print(msg, flush=True)


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def check(name, err, limit):
    log(f"  {name}: {err:.3e} (limit {limit:.0e})")
    if not err <= limit:
        raise AssertionError(f"{name}: {err} > {limit}")


def timed(fn, reps=3):
    """(first-call seconds, median of ``reps`` warm calls, last output);
    every call ends in block_until_ready."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    warm = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        warm.append(time.perf_counter() - t0)
    return first, statistics.median(warm), out


def record_compiles():
    """A list that collects (function name, seconds) of every XLA
    compilation from now on, and the persistent cache's state."""
    import os
    import jax

    cache = jax.config.jax_compilation_cache_dir
    found = len(os.listdir(cache)) if cache and os.path.isdir(cache) else 0
    log(f"compile cache: {cache} ({found} entries at start)")
    compiles = []

    def listener(event, duration, **kwargs):
        if event == "/jax/core/compile/backend_compile_duration":
            compiles.append((kwargs.get("fun_name", "?"), duration))

    jax.monitoring.register_event_duration_secs_listener(listener)
    return compiles


def print_compiles(compiles):
    while compiles:
        name, secs = compiles.pop(0)
        log(f"  compiled {name}: {secs:.2f} s")


def peak_bytes(device):
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


# ----------------------------------------------------------------------
# Phases (each takes what it works on, so it can run at any size)
# ----------------------------------------------------------------------

def phase_device(devices):
    """Print the devices and the card; fail unless they are GPUs."""
    from graphflow_tpu.utils.profiling import gpu_card

    d = devices[0]
    log(f"device: platform={d.platform} kind={d.device_kind} "
        f"count={len(devices)}")
    if d.platform != "gpu":
        raise RuntimeError(f"the default backend is {d.platform}, not gpu")
    log(f"card (name, power.limit): {gpu_card()}")


def make_batch(V, n_graphs, seed=0):
    """``n_graphs`` random graphs of V vertices at molecule-like sparsity
    (expected degree 4), and regression targets (edges per vertex)."""
    from graphflow_tpu.utils.datasets import random_graph

    graphs = [random_graph(V, 4.0 / (V - 1), seed=seed + s)
              for s in range(n_graphs)]
    targets = [float(np.triu(g.adj, 1).sum()) / V for g in graphs]
    return graphs, targets


def phase_gather(model, graph, device, seed=0):
    """T from the model's gather vs a NumPy gather, bit for bit, for each
    level's neighbor maps of ``graph`` and f32 / bf16 states."""
    import jax
    import jax.numpy as jnp
    from graphflow_tpu.models.smp2d import _gather_neighbor_tensors

    pg = model.prepare(graph)
    cfg = model.cfg
    V, P, C = cfg.max_nVertices, cfg.P, cfg.nChanels
    rng = np.random.RandomState(seed)
    gather = jax.jit(_gather_neighbor_tensors)
    for dtype in (jnp.float32, jnp.bfloat16):
        state = np.array(jnp.asarray(rng.randn(V, P + 1, P + 1, C), dtype))
        state[:, P, :, :] = 0
        state[:, :, P, :] = 0
        ext = np.concatenate([state, np.zeros_like(state[:1])])
        for l in range(cfg.nLevels):
            nbr, pos = pg.nbr[l], pg.pos[l]
            got = np.asarray(gather(*jax.device_put((state, nbr, pos),
                                                    device)))
            want = ext[nbr[:, :, None, None], pos[:, :, :, None],
                       pos[:, :, None, :]]
            same = got.shape == want.shape and np.array_equal(
                got.view(np.uint8), want.view(np.uint8))
            log(f"  gather level {l} {jnp.dtype(dtype).name}: T {got.shape} "
                f"bit-exact={same}, "
                f"{int(np.sum(got != want)) if got.shape == want.shape else -1}"
                f" elements differ")
            if not same:
                raise AssertionError("gathered T is not bit-exact")


def phase_train(model, graphs, targets, lr=LEARNING_RATE, steps=4):
    """``steps`` BatchLearn calls; the loss must be finite and strictly
    falling.  Returns (first-call seconds, warm median seconds)."""
    import jax

    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        before, after = model.BatchLearn(graphs, targets, lr)
        jax.block_until_ready(model.params)
        times.append(time.perf_counter() - t0)
        losses.append((before, after))
    log("  BatchLearn (loss before, loss after): "
        + ", ".join(f"({a:.6g}, {b:.6g})" for a, b in losses))
    flat = [x for pair in losses for x in pair]
    if not np.all(np.isfinite(flat)):
        raise AssertionError("non-finite training loss")
    if not all(b < a for a, b in losses) or not all(
            losses[i + 1][0] < losses[i][0] for i in range(steps - 1)):
        raise AssertionError(f"training loss is not strictly falling: "
                             f"{losses}")
    return times[0], statistics.median(times[1:])


def phase_predict(model, graphs):
    """Threaded_Predict on the batch and Feature on each graph: finite.
    Returns (predictions, features, predict first-call s, warm median s)."""
    first, warm, preds = timed(lambda: model.Threaded_Predict(graphs))
    feats = np.stack([model.Feature(g) for g in graphs])
    if not (np.all(np.isfinite(preds)) and np.all(np.isfinite(feats))):
        raise AssertionError("non-finite predictions or features")
    log(f"  predictions {np.asarray(preds).shape}, features {feats.shape}: "
        f"finite")
    return np.asarray(preds), feats, first, warm


def bf16_model(model):
    """The same model in bfloat16, carrying ``model``'s weights."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from graphflow_tpu.models.smp2d import SMP2D

    m = SMP2D(dataclasses.replace(model.cfg, dtype="bfloat16"))
    m.params = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16),
                                      model.params)
    return m


def phase_reference(model, graphs, targets, preds, feats, preds_bf16,
                    cpu_device):
    """Compare with the plain float32 path at matmul precision "highest"
    (same weights, same batch) and that path with the CPU backend."""
    import jax

    batch = model._stack(graphs, targets)
    _, grads = model._batch_grad(model.params, batch)
    with jax.default_matmul_precision("highest"):
        preds_hi = model.Threaded_Predict(graphs)
        feats_hi = np.stack([model.Feature(g) for g in graphs])
        _, grads_hi = model._batch_grad(model.params, batch)
        one = model._stack(graphs[:1])
        pred1, feat1 = model._jit_forward(model.params, one)
        with jax.default_device(cpu_device):
            params_cpu = jax.device_put(model.params, cpu_device)
            one_cpu = jax.device_put(one, cpu_device)
            pred1_cpu, feat1_cpu = model._jit_forward(params_cpu, one_cpu)
    check("f32 predictions vs highest", rel_err(preds, preds_hi), TOL_F32)
    check("f32 features vs highest", rel_err(feats, feats_hi), TOL_F32)
    grad_err = max(rel_err(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(grads), jax.tree_util.tree_leaves(grads_hi)))
    check("f32 batch gradient vs highest (worst leaf)", grad_err, TOL_GRAD)
    check("bf16 predictions vs f32 highest", rel_err(preds_bf16, preds_hi),
          TOL_BF16)
    check("highest prediction, card vs CPU backend",
          rel_err(pred1, pred1_cpu), TOL_CPU)
    check("highest feature, card vs CPU backend",
          rel_err(feat1, feat1_cpu), TOL_CPU)


def run_one(devices, compiles):
    """The one-card phases after the device check."""
    import jax
    from graphflow_tpu.models import SMP_omega

    t_all = time.perf_counter()
    dev = devices[0]
    model = SMP_omega(**FULL, seed=0)
    graphs, targets = make_batch(FULL["max_nVertices"], N_GRAPHS)
    t0 = time.perf_counter()
    for g in graphs:
        model.prepare(g)
    log(f"  prepared {len(graphs)} graphs in "
        f"{time.perf_counter() - t0:.2f} s (core/prep)")

    log("phase gather")
    phase_gather(model, graphs[0], dev)
    print_compiles(compiles)

    log("phase train")
    first, warm = phase_train(model, graphs, targets)
    log(f"  BatchLearn: first call {first:.3f} s, warm median {warm:.4f} s")
    print_compiles(compiles)
    log(f"  peak_bytes_in_use: {peak_bytes(dev)}")

    log("phase predict f32")
    preds, feats, first, warm = phase_predict(model, graphs)
    log(f"  Threaded_Predict f32: first call {first:.3f} s, "
        f"warm median {warm:.4f} s")
    print_compiles(compiles)

    log("phase predict bf16")
    m16 = bf16_model(model)
    first, warm, preds_bf16 = timed(lambda: m16.Threaded_Predict(graphs))
    if not np.all(np.isfinite(np.asarray(preds_bf16, np.float32))):
        raise AssertionError("non-finite bf16 predictions")
    log(f"  Threaded_Predict bf16: finite; first call {first:.3f} s, "
        f"warm median {warm:.4f} s")
    print_compiles(compiles)

    log("phase reference")
    phase_reference(model, graphs, targets, preds, feats,
                    np.asarray(preds_bf16, np.float32),
                    jax.devices("cpu")[0])
    print_compiles(compiles)
    log(f"  peak_bytes_in_use: {peak_bytes(dev)}")
    log(f"total {time.perf_counter() - t_all:.1f} s")


def run_four(devices, compiles):
    """dryrun_multichip at full width on 4 devices, both legs at
    "highest" precision."""
    import jax
    from __graft_entry__ import dryrun_multichip
    from graphflow_tpu.models.smp2d import SMP2DConfig

    if len(devices) < 4:
        raise RuntimeError(f"--four needs 4 devices, have {len(devices)}")
    graphs, targets = make_batch(FULL["max_nVertices"], N_GRAPHS)
    t0 = time.perf_counter()
    with jax.default_matmul_precision("highest"):
        errors = dryrun_multichip(4, SMP2DConfig(**FULL), graphs, targets)
    for name, err in errors.items():
        log(f"  {name}: {err:.3e}")
    print_compiles(compiles)
    log(f"  peak_bytes_in_use (device 0): {peak_bytes(devices[0])}")
    log(f"total {time.perf_counter() - t0:.1f} s")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-device path, on 4 GPUs")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    log("phase device")
    phase_device(devices)
    compiles = record_compiles()
    (run_four if args.four else run_one)(devices, compiles)
    dev = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
