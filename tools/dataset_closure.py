"""Dataset-scale closure: train SMP_omega and GCN_1D on ~100 deterministic
molecules in BOTH frameworks from IDENTICAL initial weights, and record the
per-iteration loss curves, held-out MAE and wall times as one JSON
object on stdout.

The reference side is tools/dataset_closure.cpp (compiled against the
read-only headers); molecules/targets come from one shared LCG stream so
the two runs see byte-identical data.  Our side runs float32 on the
default accelerator; the reference runs float64 serial CPU — the comparison is loss-curve
TRACKING (few-percent gap), not bit parity (that is what the parity
harness pins).

Run from the repo root:  python tools/dataset_closure.py
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
REFERENCE = "/root/reference"


class LCG:
    def __init__(self, seed):
        self.s = seed & 0xFFFFFFFFFFFFFFFF

    def next(self):
        self.s = (self.s * 6364136223846793005
                  + 1442695040888963407) & 0xFFFFFFFFFFFFFFFF
        return ((self.s >> 33) & 0x7FFFFFFF) / float(0x7FFFFFFF) - 0.5


def make_molecule(lcg, n, nFeat):
    from graphflow_tpu.core.graph import DenseGraph

    feats = np.zeros((n, nFeat))
    for u in range(n):
        fi = min(int((lcg.next() + 0.5) * nFeat), nFeat - 1)
        feats[u, fi] = 1.0
    adj = np.zeros((n, n), dtype=int)
    for u in range(n):
        for v in range(u + 1, n):
            if lcg.next() < -0.1:
                adj[u, v] = adj[v, u] = 1
    for u in range(n - 1):
        adj[u, u + 1] = adj[u + 1, u] = 1
    edges = np.argwhere(np.triu(adj))
    return DenseGraph.from_edges(n, nFeat, edges, feats)


def make_dataset(nMol, nLo, nHi, nFeat, seed):
    lcg = LCG(seed)
    mols, targets = [], []
    for _ in range(nMol):
        span = nHi - nLo + 1
        n = min(nLo + int((lcg.next() + 0.5) * span), nHi)
        mols.append(make_molecule(lcg, n, nFeat))
        targets.append(float(n) + 2.0 * lcg.next())
    return mols, targets


def write_weights(fn, arrays):
    with open(fn, "w") as f:
        for a in arrays:
            for v in np.asarray(a, np.float64).reshape(-1):
                f.write(f"{float(v)} ")


def run_reference(kind, binary, args):
    out = subprocess.run([binary, kind] + [str(a) for a in args],
                         check=True, capture_output=True, text=True,
                         timeout=7200).stdout
    curve, secs, mae = [], None, None
    for line in out.splitlines():
        t = line.split()
        if t[0] == "iter":
            curve.append([float(t[2]), float(t[3])])
        elif t[0] == "train_seconds":
            secs = float(t[1])
        elif t[0] == "test_mae":
            mae = float(t[1])
    return curve, secs, mae


def closure_omega(cfgv, mols, targets, nTrain, nTest, iters, lr, seed):
    from graphflow_tpu.models import SMP_omega

    V, rf, L, C, nFeat, nDepth = cfgv
    model = SMP_omega(max_nVertices=V, max_receptive_field=rf, nLevels=L,
                      nChanels=C, nFeatures=nFeat, nDepth=nDepth, seed=0)
    wfn = "/tmp/closure_omega_w.txt"
    arrays = [model.params["H"]]
    for l in range(L):
        arrays += [model.params["levels"][l]["K"],
                   model.params["levels"][l]["b"]]
    arrays.append(model.params["W"])
    write_weights(wfn, arrays)

    train, ttrain = mols[:nTrain], targets[:nTrain]
    curve = []
    model.getLoss(train, ttrain)          # compile + warm
    t0 = time.perf_counter()
    for _ in range(iters):
        lb, la = model.BatchLearn(train, ttrain, lr)
        curve.append([lb, la])
    secs = time.perf_counter() - t0
    preds = [model.Predict(m) for m in mols[nTrain:]]
    mae = float(np.mean(np.abs(np.array(preds) - targets[nTrain:])))

    ref_curve, ref_secs, ref_mae = run_reference(
        "omega", "/tmp/closure_omega",
        [nTrain, nTest, 8, 14, V, rf, L, C, nFeat, nDepth, iters, lr,
         seed, wfn])
    f64_curve, f64_mae = run_ours_f64("omega")
    return dict(ours={"curve": curve, "train_seconds": round(secs, 3),
                      "test_mae": mae},
                ours_f64_cpu={"curve": f64_curve, "test_mae": f64_mae},
                reference={"curve": ref_curve, "train_seconds": ref_secs,
                           "test_mae": ref_mae})


def closure_gcn1d(cfgv, mols, targets, nTrain, nTest, iters, lr, seed):
    from graphflow_tpu.models.gcn import GCN_1D

    V, R, L, H, nFeat, nDepth = cfgv
    model = GCN_1D(L, V, nFeat, H, nDepth, R, seed=0)
    wfn = "/tmp/closure_gcn1d_w.txt"
    arrays = []
    for l in range(L + 1):
        arrays.append(model.params["levels"][l]["W1"])
        if l > 0:
            arrays.append(model.params["levels"][l]["W2"])
    arrays.append(model.params["W"])
    write_weights(wfn, arrays)

    train, ttrain = mols[:nTrain], targets[:nTrain]
    curve = []
    model.getLoss(train, ttrain)
    t0 = time.perf_counter()
    for _ in range(iters):
        lb, la = model.BatchLearn(train, ttrain, lr)
        curve.append([lb, la])
    secs = time.perf_counter() - t0
    preds = [model.Predict(m) for m in mols[nTrain:]]
    mae = float(np.mean(np.abs(np.array(preds) - targets[nTrain:])))

    ref_curve, ref_secs, ref_mae = run_reference(
        "gcn1d", "/tmp/closure_gcn1d",
        [nTrain, nTest, 8, 14, V, R, L, H, nFeat, nDepth, iters, lr,
         seed, wfn])
    f64_curve, f64_mae = run_ours_f64("gcn1d")
    return dict(ours={"curve": curve, "train_seconds": round(secs, 3),
                      "test_mae": mae},
                ours_f64_cpu={"curve": f64_curve, "test_mae": f64_mae},
                reference={"curve": ref_curve, "train_seconds": ref_secs,
                           "test_mae": ref_mae})


def run_f64_leg(kind):
    """Subprocess mode: OUR framework in float64 on CPU, same data + the
    SAME weights file the reference loads — the semantics leg.  If this
    tracks the reference at ~1e-6, any f32 accelerator gap is precision, not
    semantics."""
    import jax
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    import dataclasses

    nTrain, nTest, iters, seed = 96, 32, 25, 424242
    nFeat = 4
    mols, targets = make_dataset(nTrain + nTest, 8, 14, nFeat, seed)
    if kind == "omega":
        from graphflow_tpu.models.smp2d import SMP2D, SMP2DConfig
        cfg = SMP2DConfig(max_nVertices=14, max_receptive_field=8,
                          nLevels=2, nChanels=12, nFeatures=4, nDepth=3,
                          contraction=18, optimizer="adam",
                          dtype="float64")
        model = SMP2D(cfg, seed=0)
        model.load_model("/tmp/closure_omega_w.txt")
        lr = 2e-4
    else:
        from graphflow_tpu.models.gcn import GCN, GCNConfig
        cfg = GCNConfig(nLevels=2, max_nVertices=14, nFeatures=4,
                        nHiddens=12, nDepth=3, max_Radius=2, order=1,
                        dtype="float64")
        model = GCN(cfg, seed=0)
        model.load_model("/tmp/closure_gcn1d_w.txt")
        lr = 5e-4
    train, ttrain = mols[:nTrain], targets[:nTrain]
    for it in range(iters):
        lb, la = model.BatchLearn(train, ttrain, lr)
        print(f"iter {it} {lb!r} {la!r}", flush=True)
    preds = [model.Predict(m) for m in mols[nTrain:]]
    mae = float(np.mean(np.abs(np.array(preds) - targets[nTrain:])))
    print(f"train_seconds 0")
    print(f"test_mae {mae!r}")


def run_ours_f64(kind):
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--f64", kind],
        check=True, capture_output=True, text=True, timeout=7200).stdout
    curve, mae = [], None
    for line in out.splitlines():
        t = line.split()
        if not t:
            continue
        if t[0] == "iter":
            curve.append([float(t[2]), float(t[3])])
        elif t[0] == "test_mae":
            mae = float(t[1])
    return curve, mae


def gap(section):
    a = section["ours"]["curve"][-1][1]
    b = section["reference"]["curve"][-1][1]
    return abs(a - b) / max(abs(b), 1e-12)


def semantic_gap(section):
    """Max relative per-iteration gap of the f64-CPU leg vs the
    reference — the semantics closure number."""
    a = section["ours_f64_cpu"]["curve"]
    b = section["reference"]["curve"]
    return max(abs(x[1] - y[1]) / max(abs(y[1]), 1e-12)
               for x, y in zip(a, b))


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--f64":
        run_f64_leg(sys.argv[2])
        return
    nTrain, nTest, iters, seed = 96, 32, 25, 424242
    nFeat = 4

    mols, targets = make_dataset(nTrain + nTest, 8, 14, nFeat, seed)

    print("[closure] SMP_omega ...", flush=True)
    omega = closure_omega((14, 8, 2, 12, nFeat, 3), mols, targets,
                          nTrain, nTest, iters, 2e-4, seed)
    print(f"[closure] omega final: ours {omega['ours']['curve'][-1][1]:.3f} "
          f"ref {omega['reference']['curve'][-1][1]:.3f} "
          f"(gap {100 * gap(omega):.2f}%; f64 semantic max-iter gap "
          f"{100 * semantic_gap(omega):.4f}%)", flush=True)

    print("[closure] GCN_1D ...", flush=True)
    gcn = closure_gcn1d((14, 2, 2, 12, nFeat, 3), mols, targets,
                        nTrain, nTest, iters, 5e-4, seed)
    print(f"[closure] gcn1d final: ours {gcn['ours']['curve'][-1][1]:.3f} "
          f"ref {gcn['reference']['curve'][-1][1]:.3f} "
          f"(gap {100 * gap(gcn):.2f}%; f64 semantic max-iter gap "
          f"{100 * semantic_gap(gcn):.4f}%)", flush=True)

    out = {
        "workload": {"nTrain": nTrain, "nTest": nTest, "n_range": [8, 14],
                     "iters": iters, "seed": seed,
                     "omega": "V=14 rf=8 L=2 C=12 nDepth=3 Adam lr=2e-4",
                     "gcn1d": "V=14 R=2 L=2 H=12 nDepth=3 Momentum "
                              "lr=5e-4"},
        "note": "identical molecules/targets/init weights both sides; "
                "ours = float32 on the default accelerator, reference = float64 serial CPU "
                "(tools/dataset_closure.cpp); tracking comparison, "
                "bit parity lives in the parity harness",
        "SMP_omega": omega,
        "GCN_1D": gcn,
        "final_loss_gap_pct": {"SMP_omega": round(100 * gap(omega), 3),
                               "GCN_1D": round(100 * gap(gcn), 3)},
        "semantic_max_iter_gap_pct_f64": {
            "SMP_omega": round(100 * semantic_gap(omega), 5),
            "GCN_1D": round(100 * semantic_gap(gcn), 5)},
    }
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
