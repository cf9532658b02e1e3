"""Binary activation parity, part 2: GCN_1D,
GRU_GCN_1D, NeuralFingerprint, and SMP_omega_pairgraphs against the
compiled reference headers.

tools/parity_model_reference2.cpp (one binary per kind — the reference
headers collide at file scope) builds each reference model on a
deterministic molecule, loads weights from file, runs one forward and
dumps every per-level hidden, the head intermediates and the prediction.
Here the identical molecule + weights run through graphflow_tpu in
float64 and every activation must match at 1e-9 — pinning the WL
depth-bucketed features, neighbor-radius masks, RisiLayer aggregation,
the GRU gate wiring, the two-tower level features, the interleaved
concat and the MLP head in one stroke (reference internals
``GCN_1D.h:213-260``, ``GRU_GCN_1D.h:100-160``,
``NeuralFingerprint.h:58-106``, ``SMP_omega_pairgraphs.h:657-731``).
"""

import os
import subprocess

import numpy as np
import pytest
import jax

from graphflow_tpu.core import prep, batching

from test_model_parity import build_molecule, _LCG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HARNESS_SRC = os.path.join(REPO, "tools", "parity_model_reference2.cpp")
REFERENCE = "/root/reference"

KINDS = {"gcn1d": "GCN1D", "gcn2d": "GCN2D", "gcn3d": "GCN3D",
         "gru": "GRU", "nf": "NF", "omegapair": "OMEGAPAIR",
         "smp2dver4": "SMP2DVER4"}


def _bin(kind):
    return f"/tmp/graphflow_parity_{kind}"


def _build():
    if not os.path.isdir(REFERENCE):
        return False
    try:
        src_mtime = os.path.getmtime(HARNESS_SRC)
        for kind, macro in KINDS.items():
            if (os.path.exists(_bin(kind))
                    and os.path.getmtime(_bin(kind)) > src_mtime):
                continue
            subprocess.run(
                ["g++", "-O2", "-std=c++11", "-pthread", f"-I{REFERENCE}",
                 f"-DPARITY_KIND_{macro}", HARNESS_SRC, "-o", _bin(kind)],
                check=True, capture_output=True, timeout=300)
        return True
    except Exception:
        return False


pytestmark = [pytest.mark.skipif(not _build(),
                                 reason="reference tree or g++ unavailable"),
              pytest.mark.slow]


def _tokens(kind, args):
    out = subprocess.run([_bin(kind), kind] + [str(a) for a in args],
                         check=True, capture_output=True, timeout=300,
                         text=True)
    lines = [l for l in out.stdout.splitlines()
             if l and not l.startswith("#")]
    toks = " ".join(lines).split()
    pos = [0]

    def take(k):
        vals = np.array([float(x) for x in toks[pos[0]:pos[0] + k]])
        pos[0] += k
        return vals

    def done():
        assert pos[0] == len(toks), (pos[0], len(toks))

    return take, done


def _write_weights(fn, arrays):
    with open(fn, "w") as f:
        for a in arrays:
            for v in np.asarray(a, np.float64).reshape(-1):
                f.write(f"{float(v)} ")


def _g64(pg):
    batch = batching.stack_graphs([pg])
    return jax.tree_util.tree_map(
        lambda x: x[0].astype(np.float64)
        if np.issubdtype(np.asarray(x).dtype, np.floating) else x[0], batch)


def _cast64(tree):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float64), tree)


# ----------------------------------------------------------------------
# GCN_1D
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n,V,L,H,R,seed", [
    (6, 6, 2, 5, 1, 606),
    (8, 9, 3, 4, 2, 707),     # padded V, radius growth capped at R=2
])
def test_gcn1d_matches_reference_binary(tmp_path, n, V, L, H, R, seed):
    from graphflow_tpu.models.gcn import (GCNConfig, init_gcn_params,
                                          gcn_states)

    nFeat, nDepth = 4, 3
    cfg = GCNConfig(nLevels=L, max_nVertices=V, nFeatures=nFeat, nHiddens=H,
                    nDepth=nDepth, max_Radius=R, order=1, dtype="float64")
    params = _cast64(init_gcn_params(jax.random.PRNGKey(0), cfg))
    mol = build_molecule(n, nFeat, seed)

    fn = str(tmp_path / "w.txt")
    arrays = []
    for l in range(L + 1):
        arrays.append(params["levels"][l]["W1"])
        if l > 0:
            arrays.append(params["levels"][l]["W2"])
    arrays.append(params["W"])
    _write_weights(fn, arrays)

    take, done = _tokens("gcn1d", [n, V, L, H, nFeat, nDepth, R, seed, fn])
    pg = prep.prepare_graph(mol, L, V, 1, nDepth, dtype=np.float64)
    g = _g64(pg)
    states, final = gcn_states(params, g, cfg)
    for l in range(L + 1):
        ours = np.asarray(states[l])[:n]
        for v in range(n):
            np.testing.assert_allclose(ours[v], take(H), rtol=1e-9,
                                       atol=1e-12,
                                       err_msg=f"level {l} vertex {v}")
    np.testing.assert_allclose(np.asarray(final), take(H), rtol=1e-9,
                               atol=1e-12, err_msg="final_feature")
    pred = float(np.asarray(final) @ np.asarray(params["W"]))
    np.testing.assert_allclose(pred, take(1)[0], rtol=1e-9)
    done()


@pytest.mark.parametrize("kind,order,n,V,L,H,R,seed", [
    ("gcn2d", 2, 6, 6, 2, 5, 1, 1212),
    ("gcn2d", 2, 7, 8, 2, 4, 2, 1313),
    ("gcn3d", 3, 6, 6, 2, 4, 1, 1414),
    ("gcn3d", 3, 5, 7, 2, 3, 2, 1515),
])
def test_gcn_2d_3d_match_reference_binary(tmp_path, kind, order, n, V, L,
                                          H, R, seed):
    """GCN_2D/GCN_3D: pins the RisiLayer2D closed form
    (inclusion-exclusion over unordered pairs, GCN_2D.h:77-86) and
    RisiLayer3D + KMax pooling (GCN_3D.h:77-87)."""
    from graphflow_tpu.models.gcn import (GCNConfig, init_gcn_params,
                                          gcn_states)

    nFeat, nDepth = 4, 3
    cfg = GCNConfig(nLevels=L, max_nVertices=V, nFeatures=nFeat, nHiddens=H,
                    nDepth=nDepth, max_Radius=R, order=order,
                    uncapped_radius=(order == 2), dtype="float64")
    params = _cast64(init_gcn_params(jax.random.PRNGKey(0), cfg))
    mol = build_molecule(n, nFeat, seed)

    fn = str(tmp_path / "w.txt")
    arrays = []
    for l in range(L + 1):
        arrays.append(params["levels"][l]["W1"])
        if l > 0:
            arrays.append(params["levels"][l]["W2"])
    arrays.append(params["W"])
    _write_weights(fn, arrays)

    take, done = _tokens(kind, [n, V, L, H, nFeat, nDepth, R, seed, fn])
    pg = prep.prepare_graph(mol, L, V, 1, nDepth, dtype=np.float64)
    g = _g64(pg)
    states, final = gcn_states(params, g, cfg)
    for l in range(L + 1):
        ours = np.asarray(states[l])[:n]
        for v in range(n):
            np.testing.assert_allclose(ours[v], take(H), rtol=1e-9,
                                       atol=1e-12,
                                       err_msg=f"level {l} vertex {v}")
    np.testing.assert_allclose(np.asarray(final), take(H), rtol=1e-9,
                               atol=1e-12, err_msg="final_feature")
    pred = float(np.asarray(final) @ np.asarray(params["W"]))
    np.testing.assert_allclose(pred, take(1)[0], rtol=1e-9)
    done()


# ----------------------------------------------------------------------
# GRU_GCN_1D
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n,V,L,H,R,seed", [
    (6, 6, 2, 5, 1, 808),
    (7, 8, 3, 4, 2, 909),
])
def test_gru_gcn1d_matches_reference_binary(tmp_path, n, V, L, H, R, seed):
    from graphflow_tpu.models.gru_gcn import GRU_GCN, gru_gcn_states

    nFeat, nDepth = 4, 3
    model = GRU_GCN(L, V, nFeat, H, nDepth, R, seed=0)
    params = _cast64(model.params)
    mol = build_molecule(n, nFeat, seed)

    fn = str(tmp_path / "w.txt")
    _write_weights(fn, [params[k] for k in model.param_order])

    take, done = _tokens("gru", [n, V, L, H, nFeat, nDepth, R, seed, fn])
    pg = prep.prepare_graph(mol, L, V, 1, nDepth, dtype=np.float64)
    g = _g64(pg)
    states, vertex, graph_feat = gru_gcn_states(params, g, L, R, 1, H)
    for l in range(L + 1):
        ours = np.asarray(states[l])[:n]
        for v in range(n):
            np.testing.assert_allclose(ours[v], take(H), rtol=1e-9,
                                       atol=1e-12,
                                       err_msg=f"level {l} vertex {v}")
    vx = np.asarray(vertex)[:n]
    for v in range(n):
        np.testing.assert_allclose(vx[v], take(H), rtol=1e-9, atol=1e-12,
                                   err_msg=f"vertex_feature {v}")
    np.testing.assert_allclose(np.asarray(graph_feat), take(H), rtol=1e-9,
                               atol=1e-12, err_msg="graph_feature")
    pred = float(np.asarray(graph_feat) @ np.asarray(params["U"]))
    np.testing.assert_allclose(pred, take(1)[0], rtol=1e-9)
    done()


# ----------------------------------------------------------------------
# NeuralFingerprint
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n,V,L,H,seed", [
    (6, 6, 2, 5, 111),
    (8, 10, 3, 4, 222),
])
def test_neural_fingerprint_matches_reference_binary(tmp_path, n, V, L, H,
                                                     seed):
    from graphflow_tpu.models.gcn import NeuralFingerprint, nf_states

    nFeat = 4
    model = NeuralFingerprint(L, V, nFeat, H, seed=0, aggregation="dense")
    params = _cast64(model.params)
    mol = build_molecule(n, nFeat, seed)

    fn = str(tmp_path / "w.txt")
    arrays = []
    for l in range(L + 1):
        arrays.append(params["levels"][l]["W1"])
        if l > 0:
            arrays.append(params["levels"][l]["W2"])
    arrays.append(params["W"])
    _write_weights(fn, arrays)

    take, done = _tokens("nf", [n, V, L, H, nFeat, seed, fn])
    pg = prep.prepare_graph(mol, L, V, 1, 0, use_wl_features=False,
                            dtype=np.float64)
    g = _g64(pg)
    states, final = nf_states(params, g, L)
    for l in range(L + 1):
        ours = np.asarray(states[l])[:n]
        for v in range(n):
            np.testing.assert_allclose(ours[v], take(H), rtol=1e-9,
                                       atol=1e-12,
                                       err_msg=f"level {l} vertex {v}")
    np.testing.assert_allclose(np.asarray(final), take(H), rtol=1e-9,
                               atol=1e-12)
    pred = float(np.asarray(final) @ np.asarray(params["W"]))
    np.testing.assert_allclose(pred, take(1)[0], rtol=1e-9)
    done()


# ----------------------------------------------------------------------
# SMP_omega_pairgraphs
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n1,n2,V1,V2,rf,L,C,seed", [
    (5, 6, 5, 6, 4, 2, 4, 333),
    (6, 7, 7, 8, 3, 2, 5, 444),   # padded + capped
])
def test_smp_omega_pairgraphs_matches_reference_binary(
        tmp_path, n1, n2, V1, V2, rf, L, C, seed):
    from graphflow_tpu.models.pairgraphs import SMPPairGraphs, _mlp_head_dims
    from graphflow_tpu.models.smp2d import smp2d_level_features
    from graphflow_tpu.ops import activations

    nF1 = nF2 = 4
    model = SMPPairGraphs(2, V1, V2, rf, L, C, nF1, nF2, seed=0)
    params = _cast64(model.params)
    mol1 = build_molecule(n1, nF1, seed)
    mol2 = build_molecule(n2, nF2, seed + 1000)

    fn = str(tmp_path / "w.txt")
    arrays = [params["tower1"]["H"], params["tower2"]["H"]]
    for l in range(L):
        arrays += [params["tower1"]["levels"][l]["K"],
                   params["tower1"]["levels"][l]["b"],
                   params["tower2"]["levels"][l]["K"],
                   params["tower2"]["levels"][l]["b"]]
    arrays += [params["W1"], params["W2"], params["W3"]]
    _write_weights(fn, arrays)

    take, done = _tokens("omegapair",
                         [n1, n2, V1, V2, rf, L, C, nF1, nF2, seed, fn])

    # float64 towers: rebuild the prepared graphs at f64
    cfg1, cfg2 = model.cfg1, model.cfg2
    import dataclasses
    cfg1 = dataclasses.replace(cfg1, dtype="float64")
    cfg2 = dataclasses.replace(cfg2, dtype="float64")
    pg1 = prep.prepare_graph(mol1, L, V1, rf, 0, has_WL_ordering=False,
                             use_wl_features=False, use_coulomb=False,
                             dtype=np.float64)
    pg2 = prep.prepare_graph(mol2, L, V2, rf, 0, has_WL_ordering=False,
                             use_wl_features=False, use_coulomb=False,
                             dtype=np.float64)
    g1, g2 = _g64(pg1), _g64(pg2)

    sched = cfg1.channel_schedule
    # per-tower per-level per-vertex states (size + [s, s, C_l] values)
    from graphflow_tpu.models.smp2d import smp2d_states
    st1 = smp2d_states(params["tower1"], g1, cfg1)
    st2 = smp2d_states(params["tower2"], g2, cfg2)
    for l in range(L + 1):
        Cl = sched[l]
        for (st, n, name) in ((st1, n1, "t1"), (st2, n2, "t2")):
            arr = np.asarray(st[l])
            for v in range(n):
                s_ref = int(take(1)[0])
                f_ref = take(s_ref * s_ref * Cl).reshape(s_ref, s_ref, Cl)
                np.testing.assert_allclose(
                    arr[v, :s_ref, :s_ref, :], f_ref, rtol=1e-9, atol=1e-12,
                    err_msg=f"{name} level {l} vertex {v}")

    f1 = [np.asarray(x) for x in
          smp2d_level_features(params["tower1"], g1, cfg1)]
    f2 = [np.asarray(x) for x in
          smp2d_level_features(params["tower2"], g2, cfg2)]
    for l in range(L + 1):
        np.testing.assert_allclose(f1[l], take(sched[l]), rtol=1e-9,
                                   atol=1e-12,
                                   err_msg=f"level_feature_1[{l}]")
        np.testing.assert_allclose(f2[l], take(sched[l]), rtol=1e-9,
                                   atol=1e-12,
                                   err_msg=f"level_feature_2[{l}]")
    merged = np.concatenate([x for pair in zip(f1, f2) for x in pair])
    nTotal = 2 * sum(sched)
    np.testing.assert_allclose(merged, take(nTotal), rtol=1e-9,
                               atol=1e-12, err_msg="graph_feature concat")
    h1_dim, h2_dim = _mlp_head_dims(nTotal)
    h1 = np.asarray(activations.leaky_relu(params["W1"] @ merged))
    np.testing.assert_allclose(h1, take(h1_dim), rtol=1e-9, atol=1e-12,
                               err_msg="hidden_relu_1")
    h2 = np.asarray(activations.leaky_relu(params["W2"] @ h1))
    np.testing.assert_allclose(h2, take(h2_dim), rtol=1e-9, atol=1e-12,
                               err_msg="hidden_relu_2")
    pred = float(h2 @ np.asarray(params["W3"]))
    np.testing.assert_allclose(pred, take(1)[0], rtol=1e-9)
    done()


# ----------------------------------------------------------------------
# SMP_2D (steerable second-order family)
# ----------------------------------------------------------------------

KINDS["smp2d"] = "SMP2D"


@pytest.mark.parametrize("n,V,L,C,hasWL,seed", [
    (5, 5, 2, 4, 1, 555),
    (6, 7, 2, 3, 0, 666),    # padded V, no WL ordering
])
def test_smp_2d_steerable_matches_reference_binary(tmp_path, n, V, L, C,
                                                   hasWL, seed):
    from graphflow_tpu.models.smp2d_steerable import (
        SMP2DSteerableConfig, init_params, steerable_states, forward,
        strip_radj_self_loops)

    nFeat, nDepth = 4, 3
    cfg = SMP2DSteerableConfig(
        max_nVertices=V, nLevels=L, nChanels=C, nFeatures=nFeat,
        nDepth=nDepth, filter="steerable", has_WL_ordering=bool(hasWL),
        radj_self_loops=False, dtype="float64")
    params = _cast64(init_params(jax.random.PRNGKey(0), cfg))
    mol = build_molecule(n, nFeat, seed)

    # Registration order (SMP_2D.h:227-236): H; per level, per size
    # 1..V: (lambda1[s], lambda2[s], b[s]); then scalar; then W.
    fn = str(tmp_path / "w.txt")
    arrays = [params["H"]]
    for l in range(L):
        lev = params["levels"][l]
        for s in range(1, V + 1):
            arrays += [lev["lambda1"][s], lev["lambda2"][s], lev["b"][s]]
        arrays.append(lev["scalar"])
    arrays.append(params["W"])
    _write_weights(fn, arrays)

    take, done = _tokens("smp2d", [n, V, L, C, nFeat, nDepth, hasWL, seed,
                                   fn])
    pg = prep.prepare_graph(mol, L, V, None, nDepth,
                            has_WL_ordering=bool(hasWL), dtype=np.float64)
    pg = strip_radj_self_loops(pg, mol)   # SMP_2D raw-diagonal convention
    g = _g64(pg)
    states = steerable_states(params, g, cfg)
    sizes = np.asarray(pg.sizes)
    for l in range(L + 1):
        arr = np.asarray(states[l])
        for v in range(n):
            s_ref = int(take(1)[0])
            f_ref = take(s_ref * s_ref * C).reshape(s_ref, s_ref, C)
            assert sizes[l, v] == s_ref, (l, v, sizes[l, v], s_ref)
            np.testing.assert_allclose(
                arr[v, :s_ref, :s_ref, :], f_ref, rtol=1e-9, atol=1e-12,
                err_msg=f"level {l} vertex {v}")
    pred, gf = forward(params, g, cfg)
    np.testing.assert_allclose(np.asarray(gf), take(C), rtol=1e-9,
                               atol=1e-12, err_msg="graph_feature")
    np.testing.assert_allclose(float(pred), take(1)[0], rtol=1e-9)
    done()


@pytest.mark.parametrize("n,V,L,C,hasWL,seed", [
    (5, 5, 2, 3, 1, 777),
    (6, 7, 2, 2, 1, 888),    # padded V
])
def test_smp_2d_ver4_matches_reference_binary(tmp_path, n, V, L, C, hasWL,
                                              seed):
    """SMP_2D_ver4 (vector-lambda concat filter, channel growth x2,
    forced-1 reduced-adjacency diagonal — SMP_2D_ver4.h:130-180,488-493)
    against the compiled reference binary."""
    from graphflow_tpu.models.smp2d_steerable import (
        SMP2DSteerableConfig, init_params, steerable_states, forward,
        row_normalize_radj)

    nFeat, nDepth = 4, 3
    cfg = SMP2DSteerableConfig(
        max_nVertices=V, nLevels=L, nChanels=C, nFeatures=nFeat,
        nDepth=nDepth, filter="concat", has_WL_ordering=bool(hasWL),
        radj_row_normalize=True, dtype="float64")
    params = _cast64(init_params(jax.random.PRNGKey(0), cfg))
    mol = build_molecule(n, nFeat, seed)

    fn = str(tmp_path / "w.txt")
    arrays = [params["H"]]
    for l in range(L):
        lev = params["levels"][l]
        for s in range(1, V + 1):
            arrays += [lev["lambda1"][s], lev["lambda2"][s], lev["b"][s]]
        arrays.append(lev["scalar"])
    arrays.append(params["W"])
    _write_weights(fn, arrays)

    take, done = _tokens("smp2dver4", [n, V, L, C, nFeat, nDepth, hasWL,
                                       seed, fn])
    pg = prep.prepare_graph(mol, L, V, None, nDepth,
                            has_WL_ordering=bool(hasWL), dtype=np.float64)
    pg = row_normalize_radj(pg)   # ver4: diag-1 + row-normalized
    g = _g64(pg)
    states = steerable_states(params, g, cfg)
    sizes = np.asarray(pg.sizes)
    for l in range(L + 1):
        Cl = cfg.channels_at(l)
        arr = np.asarray(states[l])
        for v in range(n):
            s_ref = int(take(1)[0])
            f_ref = take(s_ref * s_ref * Cl).reshape(s_ref, s_ref, Cl)
            assert sizes[l, v] == s_ref, (l, v, sizes[l, v], s_ref)
            np.testing.assert_allclose(
                arr[v, :s_ref, :s_ref, :], f_ref, rtol=1e-9, atol=1e-12,
                err_msg=f"level {l} vertex {v}")
    pred, gf = forward(params, g, cfg)
    np.testing.assert_allclose(np.asarray(gf), take(cfg.channels_at(L)),
                               rtol=1e-9, atol=1e-12,
                               err_msg="graph_feature")
    np.testing.assert_allclose(float(pred), take(1)[0], rtol=1e-9)
    done()


# ----------------------------------------------------------------------
# GRADIENT parity (round 5): graph->backward() vs jax.grad
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kind,order,n,V,L,H,R,seed", [
    ("gcn2d", 2, 6, 6, 2, 5, 1, 1212),
    ("gcn3d", 3, 6, 6, 2, 4, 1, 1414),
])
def test_gcn_gradients_match_reference_binary(tmp_path, kind, order, n, V,
                                              L, H, R, seed):
    """Pins the hand-written RisiLayer2D/3D and KMax backwards plus the
    diagonal Softmax backward through the full GCN loss."""
    from graphflow_tpu.models.gcn import (GCNConfig, init_gcn_params,
                                          gcn_forward)
    from graphflow_tpu.ops import losses
    import jax.numpy as jnp

    nFeat, nDepth = 4, 3
    cfg = GCNConfig(nLevels=L, max_nVertices=V, nFeatures=nFeat, nHiddens=H,
                    nDepth=nDepth, max_Radius=R, order=order,
                    uncapped_radius=(order == 2), dtype="float64")
    params = _cast64(init_gcn_params(jax.random.PRNGKey(0), cfg))
    mol = build_molecule(n, nFeat, seed)

    fn = str(tmp_path / "w.txt")
    arrays = []
    for l in range(L + 1):
        arrays.append(params["levels"][l]["W1"])
        if l > 0:
            arrays.append(params["levels"][l]["W2"])
    arrays.append(params["W"])
    _write_weights(fn, arrays)

    take, done = _tokens(kind, [n, V, L, H, nFeat, nDepth, R, seed, fn,
                                "grad"])
    take((L + 1) * n * H + H + 1)         # skip forward dumps

    pg = prep.prepare_graph(mol, L, V, 1, nDepth, dtype=np.float64)
    g = _g64(pg)

    def loss(p):
        pred, _ = gcn_forward(p, g, cfg)
        return losses.squared_loss(pred, jnp.float64(3.5))

    grads = jax.grad(loss)(params)
    for l in range(L + 1):
        for k in (("W1",) if l == 0 else ("W1", "W2")):
            got = np.asarray(grads["levels"][l][k])
            ref = take(got.size).reshape(got.shape)
            np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-10,
                                       err_msg=f"grad level {l} {k}")
    gotW = np.asarray(grads["W"])
    np.testing.assert_allclose(gotW, take(gotW.size).reshape(gotW.shape),
                               rtol=1e-8, atol=1e-10, err_msg="grad W")
    done()


def test_gru_gcn_gradients_match_reference_binary(tmp_path):
    """Pins the GRU_GCN gate backwards (W/W_z/U_z/W_r/U_r/W_h/U_h/W_g/U_g/U
    registration order, GRU_GCN_1D.h:180-189)."""
    from graphflow_tpu.models.gru_gcn import GRU_GCN, gru_gcn_states
    from graphflow_tpu.ops import losses
    import jax.numpy as jnp

    n, V, L, H, R, seed = 6, 6, 2, 5, 1, 808
    nFeat, nDepth = 4, 3
    model = GRU_GCN(L, V, nFeat, H, nDepth, R, seed=0)
    params = _cast64(model.params)
    mol = build_molecule(n, nFeat, seed)

    fn = str(tmp_path / "w.txt")
    _write_weights(fn, [params[k] for k in model.param_order])

    take, done = _tokens("gru", [n, V, L, H, nFeat, nDepth, R, seed, fn,
                                 "grad"])
    take((L + 1) * n * H + n * H + H + 1)  # skip forward dumps

    pg = prep.prepare_graph(mol, L, V, 1, nDepth, dtype=np.float64)
    g = _g64(pg)

    def loss(p):
        states, vertex, graph_feat = gru_gcn_states(p, g, L, R, 1, H)
        pred = jnp.dot(graph_feat, p["U"])
        return losses.squared_loss(pred, jnp.float64(3.5))

    grads = jax.grad(loss)(params)
    for k in model.param_order:
        got = np.asarray(grads[k])
        ref = take(got.size).reshape(got.shape)
        np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-10,
                                   err_msg=f"grad {k}")
    done()
