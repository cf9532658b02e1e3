"""Binary activation parity, part 3: CCN_1D, the
steerable leftovers (SMP_2D_ver2/ver5, Unrestricted_SMP_2D(+ver2)), SMP_1D,
LCNN, GCA_1D, the physics/Coulomb input path and the sorted-distance
GCN_*_Distance channel — pinned against the compiled reference binary.

tools/parity_model_reference3.cpp (one binary per kind — the reference
headers collide at file scope) builds each reference model on a
deterministic molecule, loads weights from file, runs one forward and dumps
every per-level intermediate.  Here the identical molecule + weights run
through graphflow_tpu in float64 and every activation must match at 1e-9.
"""

import os
import subprocess

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from graphflow_tpu.core import prep, batching

from test_model_parity import build_molecule, _LCG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HARNESS_SRC = os.path.join(REPO, "tools", "parity_model_reference3.cpp")
REFERENCE = "/root/reference"

KINDS = {"ccn1d": "CCN1D", "smp2dver2": "SMP2DVER2",
         "smp2dver3": "SMP2DVER3", "smp2dver5": "SMP2DVER5",
         "usmp2d": "USMP2D", "usmp2dver2": "USMP2DVER2",
         "smp1d": "SMP1D", "smp1dver2": "SMP1DVER2",
         "smp1dver3": "SMP1DVER3", "usmp1d": "USMP1D",
         "usmp1dver2": "USMP1DVER2", "lcnn": "LCNN", "gca1d": "GCA1D", "omegaphys": "OMEGAPHYS",
         "thetaphys": "THETAPHYS", "gcn1dd": "GCN1DD",
         "gcn2dd": "GCN2DD", "gcn3dd": "GCN3DD",
         "lstm": "LSTM", "gru": "GRU2", "sigmapair": "SIGMAPAIR",
         "omegagrad": "OMEGAGRAD"}


def _bin(kind):
    return f"/tmp/graphflow_parity3_{kind}"


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


def build_multihot_molecule(n, nFeat, seed):
    """make_molecule + the harness's deterministic multi-hot bump (so the
    CCN_1D per-vertex L1 feature normalization is exercised)."""
    mol = build_molecule(n, nFeat, seed)
    for u in range(n):
        mol.feature[u, u % nFeat] += 0.5
    return mol


# ----------------------------------------------------------------------
# CCN_1D (pair-of-graphs steerable-concat-K towers, ceil-decay channels)
# ----------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("n1,n2,V1,V2,rf,L,C,decay,seed", [
    (5, 6, 5, 6, 4, 2, 16, 1.0, 505),
    (6, 7, 7, 8, 3, 2, 17, 0.8, 606),   # padded + capped + odd-ceil decay
])
def test_ccn1d_matches_reference_binary(tmp_path, n1, n2, V1, V2, rf, L, C,
                                        decay, seed):
    """Pins the CCN_1D tower (lambda1/lambda2 W_eye/W_one concat -> K,
    ``CCN_1D.h:592-636``), the L1 feature normalization (``:440-448``),
    the ceil-decay channel schedule with 16-channel floor (``:217``) and
    the decay-sized MLP head (``:352-353``)."""
    from graphflow_tpu.models.pairgraphs import CCN_1D
    from graphflow_tpu.models.smp1d import smp1d_states, smp1d_level_features
    from graphflow_tpu.ops import activations

    nF1 = nF2 = 4
    model = CCN_1D(V1, V2, rf, L, C, nF1, nF2, nChanels_decay=decay, seed=0)
    params = _cast64(model.params)
    mol1 = build_multihot_molecule(n1, nF1, seed)
    mol2 = build_multihot_molecule(n2, nF2, seed + 1000)

    # Registration order (CCN_1D.h:382-403): H_1, H_2; per level: per size
    # 1..V1 (lambda1, lambda2, b) then K for tower 1, same for tower 2;
    # W1, W2, W3.
    fn = str(tmp_path / "w.txt")
    arrays = [params["tower1"]["H"], params["tower2"]["H"]]
    for l in range(L):
        for tower, V in (("tower1", V1), ("tower2", V2)):
            lev = params[tower]["levels"][l]
            for s in range(1, V + 1):
                arrays += [lev["lambda1"][s:s + 1], lev["lambda2"][s:s + 1],
                           lev["b"][s]]
            arrays.append(lev["K"])
    arrays += [params["W1"], params["W2"], params["W3"]]
    _write_weights(fn, arrays)

    take, done = _tokens("ccn1d", [n1, n2, V1, V2, rf, L, C, nF1, nF2,
                                   decay, seed, fn])

    cfg1, cfg2 = model.cfg1, model.cfg2
    sched = cfg1.channel_schedule
    pg1 = prep.prepare_graph(mol1, L, V1, rf, 0, has_WL_ordering=False,
                             use_wl_features=False, dtype=np.float64)
    pg2 = prep.prepare_graph(mol2, L, V2, rf, 0, has_WL_ordering=False,
                             use_wl_features=False, dtype=np.float64)
    g1, g2 = _g64(pg1), _g64(pg2)

    st1 = smp1d_states(params["tower1"], g1, cfg1)
    st2 = smp1d_states(params["tower2"], g2, cfg2)
    for l in range(L + 1):
        Cl = sched[l]
        for (st, n, name) in ((st1, n1, "t1"), (st2, n2, "t2")):
            arr = np.asarray(st[l])
            for v in range(n):
                s_ref = int(take(1)[0])
                f_ref = take(s_ref * Cl).reshape(s_ref, Cl)
                np.testing.assert_allclose(
                    arr[v, :s_ref, :], f_ref, rtol=1e-9, atol=1e-12,
                    err_msg=f"{name} level {l} vertex {v}")

    f1 = [np.asarray(x) for x in
          smp1d_level_features(params["tower1"], g1, cfg1)]
    f2 = [np.asarray(x) for x in
          smp1d_level_features(params["tower2"], g2, cfg2)]
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
    h1_dim, h2_dim = model.head_dims
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
# SMP_2D_ver2 / ver3 / ver5 (steerable leftovers)
# ----------------------------------------------------------------------

def _run_smp2dx(tmp_path, kind, cfg_kwargs, weight_layout, n, V, L, C,
                seed, radj_fixup=None):
    """Shared driver: build config+params, write weights in the reference
    registration order, run the binary, compare every per-level pre-filter
    aggregate, state, the graph feature and the prediction at 1e-9."""
    from graphflow_tpu.models.smp2d_steerable import (
        SMP2DSteerableConfig, init_params, steerable_states, forward)

    nFeat, nDepth, hasWL = 4, 3, 1
    cfg = SMP2DSteerableConfig(
        max_nVertices=V, nLevels=L, nChanels=C, nFeatures=nFeat,
        nDepth=nDepth, dtype="float64", **cfg_kwargs)
    params = _cast64(init_params(jax.random.PRNGKey(0), cfg))
    mol = build_molecule(n, nFeat, seed)

    fn = str(tmp_path / "w.txt")
    _write_weights(fn, weight_layout(params))

    take, done = _tokens(kind, [n, V, L, C, nFeat, nDepth, hasWL, seed, fn])
    pg = prep.prepare_graph(mol, L, V, None, nDepth, has_WL_ordering=True,
                            dtype=np.float64)
    if radj_fixup is not None:
        pg = radj_fixup(pg, mol)
    g = _g64(pg)
    presums = []
    states = steerable_states(params, g, cfg, collect_presum=presums)
    sizes = np.asarray(pg.sizes)
    for l in range(L + 1):
        Cl = cfg.channels_at(l)
        Cp = cfg.channels_at(l - 1) if l else None
        arr = np.asarray(states[l])
        qarr = np.asarray(presums[l - 1]) if l else None
        for v in range(n):
            s_ref = int(take(1)[0])
            assert sizes[l, v] == s_ref, (l, v, sizes[l, v], s_ref)
            f_ref = take(s_ref * s_ref * Cl).reshape(s_ref, s_ref, Cl)
            np.testing.assert_allclose(
                arr[v, :s_ref, :s_ref, :], f_ref, rtol=1e-9, atol=1e-12,
                err_msg=f"level {l} vertex {v}")
            if l:
                q_ref = take(s_ref * s_ref * Cp).reshape(s_ref, s_ref, Cp)
                np.testing.assert_allclose(
                    qarr[v, :s_ref, :s_ref, :], q_ref, rtol=1e-9,
                    atol=1e-12, err_msg=f"presum level {l} vertex {v}")
    pred, gf = forward(params, g, cfg)
    np.testing.assert_allclose(np.asarray(gf), take(cfg.channels_at(L)),
                               rtol=1e-9, atol=1e-12,
                               err_msg="graph_feature")
    np.testing.assert_allclose(float(pred), take(1)[0], rtol=1e-9)
    done()


@pytest.mark.slow
@pytest.mark.parametrize("n,V,L,C,seed", [
    (5, 5, 2, 2, 555),
    (6, 7, 2, 2, 666),    # padded V
])
def test_smp_2d_ver2_matches_reference_binary(tmp_path, n, V, L, C, seed):
    """Pins the AS-EXECUTED ver2 semantics: matrix lambdas built into a
    Tensor4D filter but applied through GraphFlow's TENSORMUL cast
    (SMP_2D_ver2.h:588 / GraphFlow.h:615-620), plus the raw-diagonal
    reduced adjacency and the scalar (.) adj term."""
    from graphflow_tpu.models.smp2d_steerable import strip_radj_self_loops

    def layout(params):
        arrays = [params["H"]]
        for l in range(len(params["levels"])):
            lev = params["levels"][l]
            for s in range(1, V + 1):
                arrays += [lev["lambda1"][s], lev["lambda2"][s], lev["b"][s]]
            arrays.append(lev["scalar"])
        arrays.append(params["W"])
        return arrays

    _run_smp2dx(tmp_path, "smp2dver2",
                dict(filter="matrix", radj_self_loops=False),
                layout, n, V, L, C, seed,
                radj_fixup=lambda pg, mol: strip_radj_self_loops(pg, mol))


@pytest.mark.slow
@pytest.mark.parametrize("n,V,L,C,seed", [
    (5, 5, 2, 2, 777),
    (6, 7, 2, 2, 888),
])
def test_smp_2d_ver3_matches_reference_binary(tmp_path, n, V, L, C, seed):
    """ver3 = ver2 minus the scalar (.) adjacency term
    (SMP_2D_ver3.h:551); same TENSORMUL cast."""
    from graphflow_tpu.models.smp2d_steerable import strip_radj_self_loops

    def layout(params):
        arrays = [params["H"]]
        for l in range(len(params["levels"])):
            lev = params["levels"][l]
            for s in range(1, V + 1):
                arrays += [lev["lambda1"][s], lev["lambda2"][s], lev["b"][s]]
        arrays.append(params["W"])
        return arrays

    _run_smp2dx(tmp_path, "smp2dver3",
                dict(filter="matrix", add_scalar_adj=False,
                     radj_self_loops=False),
                layout, n, V, L, C, seed,
                radj_fixup=lambda pg, mol: strip_radj_self_loops(pg, mol))


@pytest.mark.slow
@pytest.mark.parametrize("n,V,L,C,seed", [
    (5, 5, 2, 3, 999),
    (6, 7, 2, 2, 1111),
])
def test_smp_2d_ver5_matches_reference_binary(tmp_path, n, V, L, C, seed):
    """ver5: vector lambdas, Tensor3DConcat then the K (C x 2C) reducer
    (CustomMatMulTensor, SMP_2D_ver5.h:599-604), row-normalized diag-1
    reduced adjacency — all clean (non-cast) ops."""
    from graphflow_tpu.models.smp2d_steerable import row_normalize_radj

    def layout(params):
        arrays = [params["H"]]
        for l in range(len(params["levels"])):
            lev = params["levels"][l]
            for s in range(1, V + 1):
                arrays += [lev["lambda1"][s], lev["lambda2"][s], lev["b"][s]]
            arrays += [lev["K"], lev["scalar"]]
        arrays.append(params["W"])
        return arrays

    _run_smp2dx(tmp_path, "smp2dver5",
                dict(filter="concat_k", radj_row_normalize=True),
                layout, n, V, L, C, seed,
                radj_fixup=lambda pg, mol: row_normalize_radj(pg))


@pytest.mark.slow
@pytest.mark.parametrize("n,V,L,C,seed", [
    (5, 5, 2, 3, 2222),
    (6, 7, 2, 2, 3333),
])
def test_unrestricted_smp_2d_matches_reference_binary(tmp_path, n, V, L, C,
                                                      seed):
    """Full learned per-size Tensor3D W[s] applied by a GENUINE TensorMul
    (Unrestricted_SMP_2D.h:124,517) — constant width, raw-diagonal radj,
    scalar (.) adj term.  The per-size filters are compact (s, s, C); only
    that block of our padded Wf[s] is registered/loaded."""
    from graphflow_tpu.models.smp2d_steerable import strip_radj_self_loops

    def layout(params):
        arrays = [params["H"]]
        for l in range(len(params["levels"])):
            lev = params["levels"][l]
            for s in range(1, V + 1):
                arrays += [lev["Wf"][s][:s, :s, :], lev["b"][s]]
            arrays.append(lev["scalar"])
        arrays.append(params["W"])
        return arrays

    _run_smp2dx(tmp_path, "usmp2d",
                dict(filter="unrestricted", radj_self_loops=False),
                layout, n, V, L, C, seed,
                radj_fixup=lambda pg, mol: strip_radj_self_loops(pg, mol))


@pytest.mark.slow
@pytest.mark.parametrize("n,V,L,C,seed", [
    (5, 5, 2, 2, 4444),
    (6, 7, 2, 2, 5555),
])
def test_unrestricted_smp_2d_ver2_matches_reference_binary(tmp_path, n, V,
                                                           L, C, seed):
    """Learned per-size Tensor4D W[s] (s, s, prevC, C) consumed through the
    TENSORMUL cast (Unrestricted_SMP_2D_ver2.h:137,537) — channel growth
    x2, as-executed semantics."""
    from graphflow_tpu.models.smp2d_steerable import strip_radj_self_loops

    def layout(params):
        arrays = [params["H"]]
        for l in range(len(params["levels"])):
            lev = params["levels"][l]
            for s in range(1, V + 1):
                arrays += [lev["Wf"][s][:s, :s, :, :], lev["b"][s]]
            arrays.append(lev["scalar"])
        arrays.append(params["W"])
        return arrays

    _run_smp2dx(tmp_path, "usmp2dver2",
                dict(filter="unrestricted4d", radj_self_loops=False),
                layout, n, V, L, C, seed,
                radj_fixup=lambda pg, mol: strip_radj_self_loops(pg, mol))


# ----------------------------------------------------------------------
# SMP_1D base family (steerable / ver2 / ver3 / Unrestricted(+ver2))
# ----------------------------------------------------------------------

def _run_smp1dx(tmp_path, kind, filter_name, weight_layout, n, V, L, C,
                seed):
    """Shared first-order driver: uncapped receptive fields, WL ordering
    and WL depth-bucketed features, Momentum — the SMP_1D-family surface
    (``SMP_1D.h:32-52``)."""
    from graphflow_tpu.models.smp1d import (SMP1DConfig, init_smp1d_params,
                                            smp1d_states, smp1d_forward)

    nFeat, nDepth, hasWL = 4, 3, 1
    # The channel-growing variants run plain-ReLU towers (alpha=0 to
    # LeakyReLU2D, SMP_1D_ver2.h:491,534) — a round-5 harness catch.
    alpha = 0.0 if filter_name in ("concat", "concat_kk",
                                   "unrestricted2") else 0.01
    cfg = SMP1DConfig(
        max_nVertices=V, max_receptive_field=None, nLevels=L, nChanels=C,
        nFeatures=nFeat, nDepth=nDepth, filter=filter_name,
        tower_alpha=alpha, has_WL_ordering=bool(hasWL), dtype="float64")
    params = _cast64(init_smp1d_params(jax.random.PRNGKey(0), cfg))
    mol = build_molecule(n, nFeat, seed)

    fn = str(tmp_path / "w.txt")
    _write_weights(fn, weight_layout(params))

    take, done = _tokens(kind, [n, V, L, C, nFeat, nDepth, hasWL, seed, fn])
    pg = prep.prepare_graph(mol, L, V, None, nDepth,
                            has_WL_ordering=bool(hasWL), dtype=np.float64)
    g = _g64(pg)
    states = smp1d_states(params, g, cfg)
    sizes = np.asarray(pg.sizes)
    for l in range(L + 1):
        Cl = cfg.channels_at(l)
        arr = np.asarray(states[l])
        for v in range(n):
            s_ref = int(take(1)[0])
            if l:
                assert sizes[l, v] == s_ref, (l, v, sizes[l, v], s_ref)
            f_ref = take(s_ref * Cl).reshape(s_ref, Cl)
            np.testing.assert_allclose(
                arr[v, :s_ref, :], f_ref, rtol=1e-9, atol=1e-12,
                err_msg=f"level {l} vertex {v}")
    pred, gf = smp1d_forward(params, g, cfg)
    np.testing.assert_allclose(np.asarray(gf), take(cfg.channels_at(L)),
                               rtol=1e-9, atol=1e-12,
                               err_msg="graph_feature")
    np.testing.assert_allclose(float(pred), take(1)[0], rtol=1e-9)
    done()


def _layout_lambda(V, extra=()):
    def layout(params):
        arrays = [params["H"]]
        for lev in params["levels"]:
            for s in range(1, V + 1):
                arrays += [lev["lambda1"][s:s + 1], lev["lambda2"][s:s + 1],
                           lev["b"][s]]
            arrays += [lev[k] for k in extra]
        arrays.append(params["W"])
        return arrays
    return layout


@pytest.mark.slow
@pytest.mark.parametrize("kind,filt,extra,n,V,L,C,seed", [
    ("smp1d", "steerable", (), 5, 5, 2, 4, 6001),
    ("smp1d", "steerable", (), 6, 7, 2, 3, 6002),      # padded V
    ("smp1dver2", "concat", (), 5, 5, 2, 3, 6003),
    ("smp1dver2", "concat", (), 6, 7, 2, 2, 6004),
    ("smp1dver3", "concat_kk", ("K_eye", "K_one"), 5, 5, 2, 3, 6005),
    ("smp1dver3", "concat_kk", ("K_eye", "K_one"), 6, 7, 2, 2, 6006),
])
def test_smp1d_family_matches_reference_binary(tmp_path, kind, filt, extra,
                                               n, V, L, C, seed):
    """SMP_1D (steerable W = l1 I + l2 1, ``SMP_1D.h:480-512``), ver2
    (channel-growing concat, ``SMP_1D_ver2.h:521-529``) and ver3 (K_eye /
    K_one branch mixers, ``SMP_1D_ver3.h:542-550``)."""
    _run_smp1dx(tmp_path, kind, filt, _layout_lambda(V, extra),
                n, V, L, C, seed)


@pytest.mark.slow
@pytest.mark.parametrize("kind,filt,wkeys,n,V,L,C,seed", [
    ("usmp1d", "unrestricted", ("Wf",), 5, 5, 2, 4, 6007),
    ("usmp1d", "unrestricted", ("Wf",), 6, 7, 2, 3, 6008),
    ("usmp1dver2", "unrestricted2", ("Wf1", "Wf2"), 5, 5, 2, 3, 6009),
    ("usmp1dver2", "unrestricted2", ("Wf1", "Wf2"), 6, 7, 2, 2, 6010),
])
def test_unrestricted_smp1d_matches_reference_binary(tmp_path, kind, filt,
                                                     wkeys, n, V, L, C,
                                                     seed):
    """Unrestricted_SMP_1D (full per-size W[s], ``Unrestricted_SMP_1D.h:
    98-103``) and ver2 (two filters concatenated, ``Unrestricted_SMP_1D_
    ver2.h:102-137``).  Per-size filters are compact (s, s)."""
    def layout(params):
        arrays = [params["H"]]
        for lev in params["levels"]:
            for s in range(1, V + 1):
                arrays += [lev[k][s][:s, :s] for k in wkeys]
                arrays.append(lev["b"][s])
        arrays.append(params["W"])
        return arrays

    _run_smp1dx(tmp_path, kind, filt, layout, n, V, L, C, seed)


# ----------------------------------------------------------------------
# LCNN (PATCHY-SAN style graph CNN)
# ----------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("n,V,K,C1,C2,nDense,seed", [
    (6, 6, 3, 5, 4, 6, 7001),
    (6, 8, 4, 3, 3, 5, 7002),    # padded V (dummy vertices enter the rank)
])
def test_lcnn_matches_reference_binary(tmp_path, n, V, K, C1, C2, nDense,
                                       seed):
    """Pins the LCNN sequence construction (padded-graph WL rank +
    distance-ordered neighbor scan, LCNN.h:283-320), the by-VERTEX-id
    second gather (rows ordered by rank position, LCNN.h:69-70), and the
    dense layer consuming the raw secondConv (LCNN.h:81)."""
    from graphflow_tpu.models.lcnn import LCNN
    from graphflow_tpu.ops import activations, conv

    nFeat, nDepth = 4, 3
    model = LCNN(V, nFeat, K, nDepth, C1, C2, nDense, seed=0)
    params = _cast64(model.params)
    mol = build_molecule(n, nFeat, seed)

    fn = str(tmp_path / "w.txt")
    _write_weights(fn, [params[k] for k in model.param_order])

    take, done = _tokens("lcnn", [n, V, K, nDepth, C1, C2, nDense, nFeat,
                                  seed, fn])
    batch = model._stack([mol])
    g = jax.tree_util.tree_map(
        lambda x: x[0].astype(np.float64)
        if np.issubdtype(np.asarray(x).dtype, np.floating) else x[0], batch)

    seq_ref = take(V * K).astype(np.int64)
    np.testing.assert_array_equal(np.asarray(g["seq"]), seq_ref,
                                  err_msg="sequence")

    wl = jnp.pad(g["wl_feat"], ((0, 1), (0, 0)))
    x1 = wl[g["seq"]]
    c1 = conv.conv1d(x1, params["firstFilter"], params["firstBias"],
                     stride=K)
    np.testing.assert_allclose(np.asarray(c1).reshape(-1), take(V * C1),
                               rtol=1e-9, atol=1e-12, err_msg="firstConv")
    r1 = activations.leaky_relu(c1)
    np.testing.assert_allclose(np.asarray(r1).reshape(-1), take(V * C1),
                               rtol=1e-9, atol=1e-12, err_msg="firstReLU")
    r1p = jnp.pad(r1, ((0, 1), (0, 0)))
    c2 = conv.conv1d(r1p[g["seq"]], params["secondFilter"],
                     params["secondBias"], stride=K)
    np.testing.assert_allclose(np.asarray(c2).reshape(-1), take(V * C2),
                               rtol=1e-9, atol=1e-12, err_msg="secondConv")
    dense = params["denseWeight"] @ np.asarray(c2).reshape(-1)
    np.testing.assert_allclose(np.asarray(dense), take(nDense), rtol=1e-9,
                               atol=1e-12, err_msg="denseLayer")
    pred = float(np.asarray(dense) @ np.asarray(params["W"]))
    np.testing.assert_allclose(pred, take(1)[0], rtol=1e-9)
    done()


# ----------------------------------------------------------------------
# GCA_1D (graph autoencoder: Gram(hiddens) ~ adjacency)
# ----------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("n,V,L,H,R,seed", [
    (6, 6, 2, 5, 1, 8001),
    (7, 9, 3, 4, 2, 8002),    # padded V, radius capped at R=2
])
def test_gca1d_matches_reference_binary(tmp_path, n, V, L, H, R, seed):
    """Pins GCA_1D's growing closed-ball neighborhood (sp <= min(l, R),
    GCA_1D.h:218), the softmax hiddens with per-level W1 (feature) + W2
    (RisiLayer1D sum) mix, and the LinearGram reconstruction head
    (GCA_1D.h:242-255)."""
    from graphflow_tpu.models.gca import GCA_1D

    nFeat, nDepth = 4, 3
    model = GCA_1D(L, V, nFeat, H, nDepth, R, seed=0)
    params = _cast64(model.params)
    mol = build_molecule(n, nFeat, seed)

    fn = str(tmp_path / "w.txt")
    _write_weights(fn, [params["levels"][l][k]
                        for l in range(L + 1)
                        for k in (("W1",) if l == 0 else ("W1", "W2"))])

    take, done = _tokens("gca1d", [n, V, L, H, nFeat, nDepth, R, seed, fn])
    batch = model._stack([mol], [0.0])
    g = jax.tree_util.tree_map(
        lambda x: x[0].astype(np.float64)
        if np.issubdtype(np.asarray(x).dtype, np.floating) else x[0], batch)

    # Re-run the encoder per level to expose intermediate hiddens.
    from graphflow_tpu.ops import activations
    vmask, sp, feat = g["vmask"], g["sp"], g["wl_feat"]
    hidden = activations.softmax(
        feat @ params["levels"][0]["W1"].T) * vmask[:, None]
    hiddens = [hidden]
    for l in range(1, L + 1):
        radius = min(l, R)
        M = ((sp <= radius).astype(vmask.dtype)
             * vmask[:, None] * vmask[None, :])
        part1 = feat @ params["levels"][l]["W1"].T
        part2 = (M @ hidden) @ params["levels"][l]["W2"].T
        hidden = activations.softmax(part1 + part2) * vmask[:, None]
        hiddens.append(hidden)
    for l in range(L + 1):
        arr = np.asarray(hiddens[l])
        for v in range(n):
            np.testing.assert_allclose(arr[v], take(H), rtol=1e-9,
                                       atol=1e-12,
                                       err_msg=f"level {l} vertex {v}")
    gram = np.asarray(hidden @ hidden.T)[:n, :n]
    np.testing.assert_allclose(gram.reshape(-1), take(n * n), rtol=1e-9,
                               atol=1e-12, err_msg="LinearGram")
    adj = np.asarray(g["adj"])[:n, :n]
    loss = 0.5 * float(((gram - adj) ** 2).sum())
    np.testing.assert_allclose(loss, take(1)[0], rtol=1e-9)
    done()


# ----------------------------------------------------------------------
# The *_physics family (raw features, Coulomb adjacency, per-level MLP head)
# ----------------------------------------------------------------------

def fill_coulomb(mol, seed):
    """Replicates the harness's deterministic symmetric Coulomb stream."""
    lcg = _LCG(seed)
    n = mol.nVertices
    for u in range(n):
        for v in range(u, n):
            c = lcg.next() * 4.0
            mol.coulomb[u, v] = mol.coulomb[v, u] = c
    return mol


@pytest.mark.slow
@pytest.mark.parametrize("n,V,rf,L,C,useC,seed", [
    (5, 5, 4, 2, 4, 1, 9001),    # Coulomb reduced adjacency
    (6, 7, 3, 2, 4, 1, 9002),    # padded + capped, Coulomb
    (5, 5, 4, 2, 4, 0, 9003),    # diag-1 0/1 adjacency mode
])
def test_smp_omega_physics_matches_reference_binary(tmp_path, n, V, rf, L,
                                                    C, useC, seed):
    """Pins the physics input mode end-to-end: raw features (no WL), no WL
    ranking, the COULOMB reduced adjacency copied verbatim incl. diagonal
    (SMP_omega_physics.h:436-461), and the per-level-features MLP head
    (:211-239,585-592)."""
    from graphflow_tpu.models.physics import SMP_omega_physics
    from graphflow_tpu.models.smp2d import smp2d_states, smp2d_level_features
    from graphflow_tpu.ops import activations
    import dataclasses

    nFeat = 4
    model = SMP_omega_physics(V, rf, L, C, nFeat, use_coulomb=bool(useC),
                              seed=0)
    params = _cast64(model.params)
    mol = build_molecule(n, nFeat, seed)
    fill_coulomb(mol, seed + 777)

    fn = str(tmp_path / "w.txt")
    arrays = [params["tower"]["H"]]
    for l in range(L):
        arrays += [params["tower"]["levels"][l]["K"],
                   params["tower"]["levels"][l]["b"]]
    arrays += [params["W1"], params["W2"]]
    _write_weights(fn, arrays)

    take, done = _tokens("omegaphys", [n, V, rf, L, C, nFeat, useC, seed,
                                       fn])
    cfg = dataclasses.replace(model.cfg, dtype="float64")
    sched = cfg.channel_schedule   # physics towers HALVE channels/level
    pg = prep.prepare_graph(mol, L, V, rf, 0, has_WL_ordering=False,
                            use_wl_features=False, use_coulomb=bool(useC),
                            dtype=np.float64)
    g = _g64(pg)
    states = smp2d_states(params["tower"], g, cfg)
    sizes = np.asarray(pg.sizes)
    for l in range(L + 1):
        Cl = sched[l]
        arr = np.asarray(states[l])
        for v in range(n):
            s_ref = int(take(1)[0])
            if l:
                assert sizes[l, v] == s_ref
            f_ref = take(s_ref * s_ref * Cl).reshape(s_ref, s_ref, Cl)
            np.testing.assert_allclose(
                arr[v, :s_ref, :s_ref, :], f_ref, rtol=1e-9, atol=1e-12,
                err_msg=f"level {l} vertex {v}")
    feats = [np.asarray(x)
             for x in smp2d_level_features(params["tower"], g, cfg)]
    for l in range(L + 1):
        np.testing.assert_allclose(feats[l], take(sched[l]), rtol=1e-9,
                                   atol=1e-12,
                                   err_msg=f"level_feature[{l}]")
    gf = np.concatenate(feats)
    np.testing.assert_allclose(gf, take(sum(sched)), rtol=1e-9, atol=1e-12,
                               err_msg="graph_feature")
    hidden = np.asarray(activations.leaky_relu(params["W1"] @ gf))
    np.testing.assert_allclose(hidden, take(sum(sched) // 2), rtol=1e-9,
                               atol=1e-12, err_msg="hidden_activation")
    pred = float(hidden @ np.asarray(params["W2"]))
    np.testing.assert_allclose(pred, take(1)[0], rtol=1e-9)
    done()


@pytest.mark.slow
@pytest.mark.parametrize("n,V,rf,L,C,seed", [
    (5, 5, 4, 2, 4, 9004),
    (6, 7, 3, 2, 4, 9005),
])
def test_smp_theta_physics_matches_reference_binary(tmp_path, n, V, rf, L,
                                                    C, seed):
    """First-order physics: theta tower on raw features + the physics
    per-level MLP head (SMP_theta_physics.h:225-248)."""
    from graphflow_tpu.models.physics import SMP_theta_physics
    from graphflow_tpu.models.smp1d import smp1d_states, smp1d_level_features
    from graphflow_tpu.ops import activations
    import dataclasses

    nFeat = 4
    model = SMP_theta_physics(V, rf, L, C, nFeat, seed=0)
    params = _cast64(model.params)
    mol = build_molecule(n, nFeat, seed)

    fn = str(tmp_path / "w.txt")
    arrays = [params["tower"]["H"]]
    for l in range(L):
        lev = params["tower"]["levels"][l]
        for s in range(1, V + 1):
            arrays += [lev["lambda1"][s:s + 1], lev["lambda2"][s:s + 1],
                       lev["b"][s]]
        arrays.append(lev["K"])
    arrays += [params["W1"], params["W2"]]
    _write_weights(fn, arrays)

    take, done = _tokens("thetaphys", [n, V, rf, L, C, nFeat, seed, fn])
    cfg = dataclasses.replace(model.cfg, dtype="float64")
    sched = cfg.channel_schedule   # physics towers HALVE channels/level
    pg = prep.prepare_graph(mol, L, V, rf, 0, has_WL_ordering=False,
                            use_wl_features=False, dtype=np.float64)
    g = _g64(pg)
    states = smp1d_states(params["tower"], g, cfg)
    for l in range(L + 1):
        Cl = sched[l]
        arr = np.asarray(states[l])
        for v in range(n):
            s_ref = int(take(1)[0])
            f_ref = take(s_ref * Cl).reshape(s_ref, Cl)
            np.testing.assert_allclose(
                arr[v, :s_ref, :], f_ref, rtol=1e-9, atol=1e-12,
                err_msg=f"level {l} vertex {v}")
    feats = [np.asarray(x)
             for x in smp1d_level_features(params["tower"], g, cfg)]
    for l in range(L + 1):
        np.testing.assert_allclose(feats[l], take(sched[l]), rtol=1e-9,
                                   atol=1e-12,
                                   err_msg=f"level_feature[{l}]")
    gf = np.concatenate(feats)
    np.testing.assert_allclose(gf, take(sum(sched)), rtol=1e-9, atol=1e-12)
    hidden = np.asarray(activations.leaky_relu(params["W1"] @ gf))
    np.testing.assert_allclose(hidden, take(sum(sched) // 2), rtol=1e-9,
                               atol=1e-12, err_msg="hidden_activation")
    pred = float(hidden @ np.asarray(params["W2"]))
    np.testing.assert_allclose(pred, take(1)[0], rtol=1e-9)
    done()


# ----------------------------------------------------------------------
# GCN_{1,2,3}D_Distance (two-channel GCN with the sorted-distance channel)
# ----------------------------------------------------------------------

def fill_distance(mol, seed):
    """Replicates the harness's deterministic symmetric distance stream."""
    lcg = _LCG(seed)
    n = mol.nVertices
    for u in range(n):
        for v in range(u + 1, n):
            c = (lcg.next() + 0.5) * 3.0
            mol.distance[u, v] = mol.distance[v, u] = c
    return mol


@pytest.mark.slow
@pytest.mark.parametrize("kind,order,n,V,L,H,R,seed", [
    ("gcn1dd", 1, 6, 6, 2, 5, 1, 9101),
    ("gcn1dd", 1, 7, 9, 3, 4, 2, 9102),   # padded V
    ("gcn2dd", 2, 6, 6, 2, 4, 1, 9103),
    ("gcn3dd", 3, 6, 7, 2, 4, 2, 9104),
])
def test_gcn_distance_matches_reference_binary(tmp_path, kind, order, n, V,
                                               L, H, R, seed):
    """Pins the sorted-distance channel (ascending sort over the FULL
    padded distance column, GCN_1D_Distance.h:98-118), the per-order
    distance-channel aggregation (RisiLayer2D/3D + KMax in the 2D/3D
    variants, GCN_2D_Distance.h:141), and the interleaved registration
    order (GCN_1D_Distance.h:166-176)."""
    from graphflow_tpu.models.gcn import (GCNConfig, init_gcn_params,
                                          _channel_forward)

    nFeat, nDepth = 4, 3
    cfg = GCNConfig(nLevels=L, max_nVertices=V, nFeatures=nFeat, nHiddens=H,
                    nDepth=nDepth, max_Radius=R, order=order,
                    use_distance_channel=True, dtype="float64")
    params = _cast64(init_gcn_params(jax.random.PRNGKey(0), cfg))
    mol = build_molecule(n, nFeat, seed)
    fill_distance(mol, seed + 555)

    fn = str(tmp_path / "w.txt")
    # Channel-blocked checkpoint format (GCN_1D_Distance.h load_model):
    # all vertex-channel weights, then all distance-channel weights.
    arrays = []
    for l in range(L + 1):
        arrays.append(params["levels"][l]["W1"])
        if l > 0:
            arrays.append(params["levels"][l]["W2"])
    for l in range(L + 1):
        arrays.append(params["dlevels"][l]["W1"])
        if l > 0:
            arrays.append(params["dlevels"][l]["W2"])
    arrays.append(params["W"])
    _write_weights(fn, arrays)

    take, done = _tokens(kind, [n, V, L, H, nFeat, nDepth, R, seed, fn])
    pg = prep.prepare_graph(mol, L, V, 1, nDepth, dtype=np.float64)
    g = _g64(pg)

    vmask, sp = g["vmask"], g["sp"]
    M_of = lambda l: ((sp <= min(l, R)).astype(vmask.dtype)
                      * vmask[:, None] * vmask[None, :])
    vstates, dstates = [], []
    fv, _ = _channel_forward(params["levels"], g["wl_feat"], M_of, vmask,
                             order, H, collect=vstates)
    dist_col = g["dist"].T * vmask[:, None] * vmask[None, :]
    dist_sorted = jnp.sort(dist_col, axis=1)
    fd, _ = _channel_forward(params["dlevels"], dist_sorted, M_of, vmask,
                             order, H, collect=dstates)
    for states, name in ((vstates, "vertex"), (dstates, "distance")):
        for l in range(L + 1):
            arr = np.asarray(states[l])
            for v in range(n):
                np.testing.assert_allclose(
                    arr[v], take(H), rtol=1e-9, atol=1e-12,
                    err_msg=f"{name} level {l} vertex {v}")
    np.testing.assert_allclose(np.asarray(fv), take(H), rtol=1e-9,
                               atol=1e-12, err_msg="final_vertex")
    np.testing.assert_allclose(np.asarray(fd), take(H), rtol=1e-9,
                               atol=1e-12, err_msg="final_distance")
    pred = float(np.concatenate([np.asarray(fv), np.asarray(fd)])
                 @ np.asarray(params["W"]))
    np.testing.assert_allclose(pred, take(1)[0], rtol=1e-9)
    done()


# ----------------------------------------------------------------------
# LSTM / GRU sequence cells
# ----------------------------------------------------------------------

def _rnn_sequence(nFeat, nClasses, T, seed):
    """Replicates the harness's x/target streams (one shared LCG)."""
    lcg = _LCG(seed)
    xs = np.array([[lcg.next() for _ in range(nFeat)] for _ in range(T)])
    ts = np.array([min(int((lcg.next() + 0.5) * nClasses), nClasses - 1)
                   for _ in range(T)], dtype=np.int64)
    return xs, ts


@pytest.mark.slow
@pytest.mark.parametrize("kind,F,H,C,T,seed", [
    ("lstm", 3, 5, 4, 6, 9201),
    ("lstm", 4, 4, 3, 8, 9202),
    ("gru", 3, 5, 4, 6, 9203),
    ("gru", 4, 4, 3, 8, 9204),
])
def test_rnn_matches_reference_binary(tmp_path, kind, F, H, C, T, seed):
    """Pins the LSTM cell (peephole Vo @ memory in the output gate,
    LSTM.h:179-196), the GRU cell (reset-gated candidate, GRU.h:277-300),
    the per-step cumulative-average pooling head (LSTM.h:337-345) and the
    LogLoss sign convention."""
    from graphflow_tpu.models.rnn import LSTM, GRU, _lstm_cell, _gru_cell

    model = (LSTM if kind == "lstm" else GRU)(F, H, C, T, seed=0)
    params = _cast64(model.params)
    xs, ts = _rnn_sequence(F, C, T, seed)

    order = (["Wi", "Ui", "bi", "Wc", "Uc", "bc", "Wf", "Uf", "bf",
              "Wo", "Uo", "Vo", "bo", "theta"] if kind == "lstm" else
             ["W_z", "U_z", "b_z", "W_r", "U_r", "b_r", "W_h", "U_h",
              "b_h", "theta"])
    fn = str(tmp_path / "w.txt")
    _write_weights(fn, [params[k] for k in order])

    take, done = _tokens(kind, [F, H, C, T, seed, fn])

    # f64 rollout through our cells
    if kind == "lstm":
        carry = (jnp.zeros((H,), jnp.float64), jnp.zeros((H,), jnp.float64))
        hs = []
        for t in range(T):
            carry, h = _lstm_cell(params, carry, jnp.asarray(xs[t]))
            hs.append(np.asarray(h))
    else:
        h = jnp.zeros((H,), jnp.float64)
        hs = []
        for t in range(T):
            h, _ = _gru_cell(params, h, jnp.asarray(xs[t]))
            hs.append(np.asarray(h))
    hs = np.stack(hs)
    pooled = np.cumsum(hs, axis=0) / np.arange(1, T + 1)[:, None]
    logits = pooled @ np.asarray(params["theta"]).T
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs = e / e.sum(axis=1, keepdims=True)
    for t in range(T):
        np.testing.assert_allclose(hs[t], take(H), rtol=1e-9, atol=1e-12,
                                   err_msg=f"hidden[{t}]")
        np.testing.assert_allclose(pooled[t], take(H), rtol=1e-9,
                                   atol=1e-12, err_msg=f"average_pool[{t}]")
        np.testing.assert_allclose(probs[t], take(C), rtol=1e-9, atol=1e-12,
                                   err_msg=f"softmax[{t}]")
    # LogLoss consumes the SOFTMAX node, i.e. the reference objective is a
    # double softmax; getLoss returns the sum of log-likelihoods (negative
    # numbers, higher is better) while our loss is the NLL.
    e2 = np.exp(probs - probs.max(axis=1, keepdims=True))
    probs2 = e2 / e2.sum(axis=1, keepdims=True)
    nll = -np.log(probs2[np.arange(T), ts]).sum()
    ref_loss = take(1)[0]
    np.testing.assert_allclose(-ref_loss, nll, rtol=1e-9)
    done()


# ----------------------------------------------------------------------
# SMP_sigma_pairgraphs (contraction-case dropout, deterministic TEST mode)
# ----------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("n1,n2,V1,V2,rf,L,C,nKept,seed", [
    (5, 6, 5, 6, 4, 2, 4, 9, 9301),
    (6, 7, 7, 8, 3, 2, 4, 5, 9302),   # padded + capped, different nKept
])
def test_sigma_pairgraphs_test_mode_matches_reference_binary(
        tmp_path, n1, n2, V1, V2, rf, L, C, nKept, seed):
    """Pins the eval-mode case-dropout scaling: ALL 18 cases scaled by
    nKept/18 (RisiContraction_18_dropout.h:466-471), plus the sigma tower
    channel halving and MLP head."""
    from graphflow_tpu.models.pairgraphs import SMPPairGraphs, _mlp_head_dims
    from graphflow_tpu.models.smp2d import smp2d_states, smp2d_level_features
    from graphflow_tpu.ops.contractions import dropout_case_mask
    from graphflow_tpu.ops import activations
    import dataclasses

    nF1 = nF2 = 4
    model = SMPPairGraphs(2, V1, V2, rf, L, C, nF1, nF2,
                          dropout_nKept=nKept, seed=0)
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

    take, done = _tokens("sigmapair", [n1, n2, V1, V2, rf, L, C, nF1, nF2,
                                       nKept, seed, fn])
    cfg1 = dataclasses.replace(model.cfg1, dtype="float64")
    cfg2 = dataclasses.replace(model.cfg2, dtype="float64")
    pg1 = prep.prepare_graph(mol1, L, V1, rf, 0, has_WL_ordering=False,
                             use_wl_features=False, dtype=np.float64)
    pg2 = prep.prepare_graph(mol2, L, V2, rf, 0, has_WL_ordering=False,
                             use_wl_features=False, dtype=np.float64)
    g1, g2 = _g64(pg1), _g64(pg2)
    mask = dropout_case_mask(jax.random.PRNGKey(0), nKept,
                             train=False).astype(np.float64)

    sched = cfg1.channel_schedule
    st1 = smp2d_states(params["tower1"], g1, cfg1, case_mask=mask)
    st2 = smp2d_states(params["tower2"], g2, cfg2, case_mask=mask)
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
    f1 = [np.asarray(x) for x in smp2d_level_features(
        params["tower1"], g1, cfg1, case_mask=mask)]
    f2 = [np.asarray(x) for x in smp2d_level_features(
        params["tower2"], g2, cfg2, case_mask=mask)]
    for l in range(L + 1):
        np.testing.assert_allclose(f1[l], take(sched[l]), rtol=1e-9,
                                   atol=1e-12)
        np.testing.assert_allclose(f2[l], take(sched[l]), rtol=1e-9,
                                   atol=1e-12)
    merged = np.concatenate([x for pair in zip(f1, f2) for x in pair])
    nTotal = 2 * sum(sched)
    np.testing.assert_allclose(merged, take(nTotal), rtol=1e-9, atol=1e-12)
    h1 = np.asarray(activations.leaky_relu(params["W1"] @ merged))
    h2 = np.asarray(activations.leaky_relu(params["W2"] @ h1))
    hd = _mlp_head_dims(nTotal)
    np.testing.assert_allclose(h1, take(hd[0]), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(h2, take(hd[1]), rtol=1e-9, atol=1e-12)
    pred = float(h2 @ np.asarray(params["W3"]))
    np.testing.assert_allclose(pred, take(1)[0], rtol=1e-9)
    done()


# ----------------------------------------------------------------------
# GRADIENT parity: reference graph->backward() vs our jax.grad
# ----------------------------------------------------------------------

@pytest.mark.slow
def test_lcnn_gradients_match_reference_binary(tmp_path):
    """graph->backward() parameter gradients vs jax.grad of the same loss
    (pins Conv1D/ShuffleMatrix/LeakyReLU/MatVecMul backwards and the
    dead-secondReLU wiring)."""
    from graphflow_tpu.models.lcnn import LCNN

    n, V, K, C1, C2, nDense, seed = 6, 6, 3, 5, 4, 6, 7001
    nFeat, nDepth = 4, 3
    model = LCNN(V, nFeat, K, nDepth, C1, C2, nDense, seed=0)
    params = _cast64(model.params)
    mol = build_molecule(n, nFeat, seed)
    fn = str(tmp_path / "w.txt")
    _write_weights(fn, [params[k] for k in model.param_order])

    take, done = _tokens("lcnn", [n, V, K, nDepth, C1, C2, nDense, nFeat,
                                  seed, fn, "grad"])
    # skip the forward dumps
    take(V * K + 2 * V * C1 + V * C2 + nDense + 1)

    batch = model._stack([mol])
    g = jax.tree_util.tree_map(
        lambda x: x[0].astype(np.float64)
        if np.issubdtype(np.asarray(x).dtype, np.floating) else x[0], batch)

    def loss(p):
        pred, _ = model._forward(p, g)
        return 0.5 * (pred - 3.5) ** 2

    grads = jax.grad(loss)(params)
    for k in model.param_order:
        ref = take(int(np.asarray(params[k]).size)).reshape(
            np.asarray(params[k]).shape)
        np.testing.assert_allclose(np.asarray(grads[k]), ref, rtol=1e-8,
                                   atol=1e-10, err_msg=f"grad {k}")
    done()


@pytest.mark.slow
def test_gca1d_gradients_match_reference_binary(tmp_path):
    """Pins the LinearGram and (diagonal) Softmax backwards through the
    autoencoder loss."""
    from graphflow_tpu.models.gca import GCA_1D
    from graphflow_tpu.ops import activations

    n, V, L, H, R, seed = 6, 6, 2, 5, 1, 8001
    nFeat, nDepth = 4, 3
    model = GCA_1D(L, V, nFeat, H, nDepth, R, seed=0)
    params = _cast64(model.params)
    mol = build_molecule(n, nFeat, seed)
    fn = str(tmp_path / "w.txt")
    _write_weights(fn, [params["levels"][l][k]
                        for l in range(L + 1)
                        for k in (("W1",) if l == 0 else ("W1", "W2"))])

    take, done = _tokens("gca1d", [n, V, L, H, nFeat, nDepth, R, seed, fn,
                                   "grad"])
    take((L + 1) * n * H + n * n + 1)      # skip forward dumps

    batch = model._stack([mol], [0.0])
    g = jax.tree_util.tree_map(
        lambda x: x[0].astype(np.float64)
        if np.issubdtype(np.asarray(x).dtype, np.floating) else x[0], batch)

    def loss(p):
        return model._loss(p, g, jnp.float64(0.0))

    grads = jax.grad(loss)(params)
    for l in range(L + 1):
        for k in (("W1",) if l == 0 else ("W1", "W2")):
            got = np.asarray(grads["levels"][l][k])
            ref = take(got.size).reshape(got.shape)
            np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-10,
                                       err_msg=f"grad level {l} {k}")
    done()


@pytest.mark.slow
@pytest.mark.parametrize("kind,F,H,C,T,seed", [
    ("lstm", 3, 5, 4, 6, 9201),
    ("gru", 3, 5, 4, 6, 9203),
])
def test_rnn_gradients_match_reference_binary(tmp_path, kind, F, H, C, T,
                                              seed):
    """Pins the LSTM/GRU cell backwards, the cumulative AverageVectors
    backward, the LogLoss gradient and the diagonal Softmax backward in
    one stroke."""
    from graphflow_tpu.models.rnn import LSTM, GRU, _lstm_cell, _gru_cell
    from graphflow_tpu.ops import activations

    model = (LSTM if kind == "lstm" else GRU)(F, H, C, T, seed=0)
    params = _cast64(model.params)
    xs, ts = _rnn_sequence(F, C, T, seed)

    order = (["Wi", "Ui", "bi", "Wc", "Uc", "bc", "Wf", "Uf", "bf",
              "Wo", "Uo", "Vo", "bo", "theta"] if kind == "lstm" else
             ["W_z", "U_z", "b_z", "W_r", "U_r", "b_r", "W_h", "U_h",
              "b_h", "theta"])
    fn = str(tmp_path / "w.txt")
    _write_weights(fn, [params[k] for k in order])

    take, done = _tokens(kind, [F, H, C, T, seed, fn, "grad"])
    take(T * (2 * H + C) + 1)              # skip forward dumps

    xs64 = jnp.asarray(xs, jnp.float64)

    def loss(p):
        if kind == "lstm":
            carry = (jnp.zeros((H,), jnp.float64),
                     jnp.zeros((H,), jnp.float64))
            hs = []
            for t in range(T):
                carry, h = _lstm_cell(p, carry, xs64[t])
                hs.append(h)
        else:
            h = jnp.zeros((H,), jnp.float64)
            hs = []
            for t in range(T):
                h, _ = _gru_cell(p, h, xs64[t])
                hs.append(h)
        hs = jnp.stack(hs)
        pooled = jnp.cumsum(hs, axis=0) / jnp.arange(
            1, T + 1, dtype=jnp.float64)[:, None]
        logits = pooled @ p["theta"].T
        probs = activations.softmax(logits, axis=-1)
        logp = jax.nn.log_softmax(probs, axis=-1)
        tsel = jnp.asarray(ts)[:, None]
        return -jnp.take_along_axis(logp, tsel, axis=1).sum()

    grads = jax.grad(loss)(params)
    for k in order:
        got = np.asarray(grads[k])
        ref = take(got.size).reshape(got.shape)
        np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-10,
                                   err_msg=f"grad {k}")
    done()


@pytest.mark.slow
@pytest.mark.parametrize("n,V,rf,L,C,seed", [
    (5, 5, 4, 2, 4, 12001),
    (6, 7, 3, 2, 4, 12002),   # padded + capped
])
def test_smp_omega_gradients_match_reference_binary(tmp_path, n, V, rf, L,
                                                    C, seed):
    """FLAGSHIP gradient parity: graph->backward() vs jax.grad through the
    full SMP_omega — pins the RisiContraction_18 backward (incl. the
    adj>0 guard's gradient), the permutation-gather adjoint, the WL
    feature path and the head in one stroke."""
    from graphflow_tpu.models.smp2d import (SMP2DConfig, init_smp2d_params,
                                            smp2d_forward)
    from graphflow_tpu.ops import losses
    import dataclasses

    nFeat, nDepth, target = 4, 3, 3.5
    cfg = SMP2DConfig(max_nVertices=V, max_receptive_field=rf, nLevels=L,
                      nChanels=C, nFeatures=nFeat, nDepth=nDepth,
                      dtype="float64")
    params = _cast64(init_smp2d_params(jax.random.PRNGKey(0), cfg))
    mol = build_molecule(n, nFeat, seed)

    fn = str(tmp_path / "w.txt")
    arrays = [params["H"]]
    for l in range(L):
        arrays += [params["levels"][l]["K"], params["levels"][l]["b"]]
    arrays.append(params["W"])
    _write_weights(fn, arrays)

    take, done = _tokens("omegagrad", [n, V, rf, L, C, nFeat, nDepth,
                                       target, seed, fn])
    pg = prep.prepare_graph(mol, L, V, rf, nDepth, dtype=np.float64)
    g = _g64(pg)

    def loss(p):
        pred, _ = smp2d_forward(p, g, cfg)
        return losses.squared_loss(pred, jnp.float64(target))

    pred, _ = smp2d_forward(params, g, cfg)
    np.testing.assert_allclose(float(pred), take(1)[0], rtol=1e-9)
    grads = jax.grad(loss)(params)
    flat = ([("H", grads["H"])]
            + [(f"levels/{l}/{k}", grads["levels"][l][k])
               for l in range(L) for k in ("K", "b")]
            + [("W", grads["W"])])
    for name, got in flat:
        got = np.asarray(got)
        ref = take(got.size).reshape(got.shape)
        np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-10,
                                   err_msg=f"grad {name}")
    done()


@pytest.mark.slow
@pytest.mark.parametrize("kind,filt,scalar,n,V,L,C,seed", [
    ("smp2dver2", "matrix", True, 5, 5, 2, 2, 555),
    ("smp2dver5", "concat_k", True, 5, 5, 2, 3, 999),
])
def test_steerable_gradients_match_reference_binary(tmp_path, kind, filt,
                                                    scalar, n, V, L, C,
                                                    seed):
    """Gradient parity through the AS-EXECUTED backward chain — for ver2
    that includes TensorMul::backward running on the reinterpreted 4-D
    filter (flat-stride writes into the Tensor4D gradient buffer, then
    Tensor4DConcat/MatBroadcastMat backwards reading it in true layout).
    jax.grad of our executed forward must equal it.

    ver5 (clean ops) matches at 1e-8.  ver2 (the TENSORMUL cast) matches
    to ~1.5e-5 relative: the shared-node prefix weighting (depth 2)
    captures the dominant structure — a residual higher-order interaction
    of TensorMul::backward's flat-stride writes with the shared-node
    accumulation remains unmodeled (documented in PARITY.md)."""
    from graphflow_tpu.models.smp2d_steerable import (
        SMP2DSteerableConfig, init_params, forward, strip_radj_self_loops,
        row_normalize_radj)
    from graphflow_tpu.ops import losses

    nFeat, nDepth, hasWL = 4, 3, 1
    cfg = SMP2DSteerableConfig(
        max_nVertices=V, nLevels=L, nChanels=C, nFeatures=nFeat,
        nDepth=nDepth, filter=filt, dtype="float64",
        **({"radj_self_loops": False} if kind == "smp2dver2"
           else {"radj_row_normalize": True}))
    params = _cast64(init_params(jax.random.PRNGKey(0), cfg))
    mol = build_molecule(n, nFeat, seed)

    fn = str(tmp_path / "w.txt")
    arrays = [params["H"]]
    for l in range(L):
        lev = params["levels"][l]
        for s in range(1, V + 1):
            arrays += [lev["lambda1"][s], lev["lambda2"][s], lev["b"][s]]
        if kind == "smp2dver5":
            arrays.append(lev["K"])
        arrays.append(lev["scalar"])
    arrays.append(params["W"])
    _write_weights(fn, arrays)

    rtol = 1e-4 if kind == "smp2dver2" else 1e-8
    take, done = _tokens(kind, [n, V, L, C, nFeat, nDepth, hasWL, seed, fn,
                                "grad"])
    # skip forward dumps: per level per vertex (1 + s^2 C_l) + presum, gf,
    # predict — sizes vary, so just consume tokens up to the known tail:
    # easier to recompute the forward token count from the sizes array.
    pg = prep.prepare_graph(mol, L, V, None, nDepth, has_WL_ordering=True,
                            dtype=np.float64)
    if kind == "smp2dver2":
        pg = strip_radj_self_loops(pg, mol)
    else:
        pg = row_normalize_radj(pg)
    sizes = np.asarray(pg.sizes)
    n_fwd = 0
    for l in range(L + 1):
        Cl = cfg.channels_at(l)
        Cp = cfg.channels_at(l - 1) if l else None
        for v in range(n):
            s_ = int(sizes[l, v]) if l else 1
            n_fwd += 1 + s_ * s_ * Cl + (s_ * s_ * Cp if l else 0)
    n_fwd += cfg.channels_at(L) + 1
    take(n_fwd)

    g = _g64(pg)

    def loss(p):
        pred, _ = forward(p, g, cfg)
        return losses.squared_loss(pred, jnp.float64(3.5))

    grads = jax.grad(loss)(params)
    gotH = np.asarray(grads["H"])
    np.testing.assert_allclose(gotH, take(gotH.size).reshape(gotH.shape),
                               rtol=rtol, atol=1e-10, err_msg="grad H")
    for l in range(L):
        lev = grads["levels"][l]
        for s in range(1, V + 1):
            for kname in ("lambda1", "lambda2", "b"):
                got = np.asarray(lev[kname][s])
                ref = take(got.size).reshape(got.shape)
                np.testing.assert_allclose(
                    got, ref, rtol=rtol, atol=1e-10,
                    err_msg=f"grad level {l} size {s} {kname}")
        if kind == "smp2dver5":
            got = np.asarray(lev["K"])
            np.testing.assert_allclose(got, take(got.size).reshape(
                got.shape), rtol=rtol, atol=1e-10,
                err_msg=f"grad level {l} K")
        got = np.asarray(lev["scalar"])
        np.testing.assert_allclose(got, take(got.size).reshape(got.shape),
                                   rtol=rtol, atol=1e-10,
                                   err_msg=f"grad level {l} scalar")
    gotW = np.asarray(grads["W"])
    np.testing.assert_allclose(gotW, take(gotW.size).reshape(gotW.shape),
                               rtol=rtol, atol=1e-10, err_msg="grad W")
    done()


@pytest.mark.slow
def test_ccn1d_gradients_match_reference_binary(tmp_path):
    """Capstone gradient parity: the two-tower CCN_1D loss end-to-end —
    pins the pairgraph head backward, both theta towers' gradients incl.
    the shared-node lambda weighting (depth 1) and the L1-normalized
    feature path."""
    from graphflow_tpu.models.pairgraphs import CCN_1D
    from graphflow_tpu.ops import losses

    n1, n2, V1, V2, rf, L, C, decay, seed = 5, 6, 5, 6, 4, 2, 16, 1.0, 505
    nF1 = nF2 = 4
    model = CCN_1D(V1, V2, rf, L, C, nF1, nF2, nChanels_decay=decay, seed=0)
    params = _cast64(model.params)
    mol1 = build_multihot_molecule(n1, nF1, seed)
    mol2 = build_multihot_molecule(n2, nF2, seed + 1000)

    fn = str(tmp_path / "w.txt")
    arrays = [params["tower1"]["H"], params["tower2"]["H"]]
    for l in range(L):
        for tower, V in (("tower1", V1), ("tower2", V2)):
            lev = params[tower]["levels"][l]
            for s in range(1, V + 1):
                arrays += [lev["lambda1"][s:s + 1], lev["lambda2"][s:s + 1],
                           lev["b"][s]]
            arrays.append(lev["K"])
    arrays += [params["W1"], params["W2"], params["W3"]]
    _write_weights(fn, arrays)

    take, done = _tokens("ccn1d", [n1, n2, V1, V2, rf, L, C, nF1, nF2,
                                   decay, seed, fn, "grad"])
    # skip the forward dumps
    sched = model.cfg1.channel_schedule
    pg1 = prep.prepare_graph(mol1, L, V1, rf, 0, has_WL_ordering=False,
                             use_wl_features=False, dtype=np.float64)
    pg2 = prep.prepare_graph(mol2, L, V2, rf, 0, has_WL_ordering=False,
                             use_wl_features=False, dtype=np.float64)
    s1, s2 = np.asarray(pg1.sizes), np.asarray(pg2.sizes)
    n_fwd = 0
    for l in range(L + 1):
        Cl = sched[l]
        for v in range(n1):
            n_fwd += 1 + (int(s1[l, v]) if l else 1) * Cl
        for v in range(n2):
            n_fwd += 1 + (int(s2[l, v]) if l else 1) * Cl
    nTotal = 2 * sum(sched)
    n_fwd += 2 * sum(sched) + nTotal + sum(model.head_dims) + 1
    take(n_fwd)

    b1 = _g64(pg1)
    b2 = _g64(pg2)

    def loss(p):
        pred = model._forward(p, b1, b2)
        return losses.squared_loss(pred, jnp.float64(3.5))

    grads = jax.grad(loss)(params)
    named = [("tower1/H", grads["tower1"]["H"]),
             ("tower2/H", grads["tower2"]["H"])]
    for l in range(L):
        for tower, V in (("tower1", V1), ("tower2", V2)):
            lev = grads[tower]["levels"][l]
            for s in range(1, V + 1):
                named += [(f"{tower}/l{l}/lambda1[{s}]",
                           lev["lambda1"][s:s + 1]),
                          (f"{tower}/l{l}/lambda2[{s}]",
                           lev["lambda2"][s:s + 1]),
                          (f"{tower}/l{l}/b[{s}]", lev["b"][s])]
            named.append((f"{tower}/l{l}/K", lev["K"]))
    named += [("W1", grads["W1"]), ("W2", grads["W2"]),
              ("W3", grads["W3"])]
    for name, got in named:
        got = np.asarray(got)
        ref = take(got.size).reshape(got.shape)
        np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-10,
                                   err_msg=f"grad {name}")
    done()



@pytest.mark.slow
@pytest.mark.parametrize("kind,filt,extra,n,V,L,C,seed", [
    ("smp1d", "steerable", (), 5, 5, 2, 4, 6001),        # depth-3 chain
    ("smp1dver3", "concat_kk", ("K_eye", "K_one"), 5, 5, 2, 3, 6005),
])
def test_smp1d_gradients_match_reference_binary(tmp_path, kind, filt,
                                                extra, n, V, L, C, seed):
    """Validates the shared-node lambda weight law at its DEEPEST chain:
    SMP_1D's lambda -> W_eye -> W_flat(Add) -> W(Reshape2D) is depth 3
    (weights r(r+1)(r+2)/6); ver3's is depth 1."""
    from graphflow_tpu.models.smp1d import (SMP1DConfig, init_smp1d_params,
                                            smp1d_forward)
    from graphflow_tpu.ops import losses

    nFeat, nDepth, hasWL = 4, 3, 1
    alpha = 0.0 if filt in ("concat", "concat_kk", "unrestricted2") else 0.01
    cfg = SMP1DConfig(
        max_nVertices=V, max_receptive_field=None, nLevels=L, nChanels=C,
        nFeatures=nFeat, nDepth=nDepth, filter=filt, tower_alpha=alpha,
        has_WL_ordering=bool(hasWL), dtype="float64")
    params = _cast64(init_smp1d_params(jax.random.PRNGKey(0), cfg))
    mol = build_molecule(n, nFeat, seed)

    fn = str(tmp_path / "w.txt")
    _write_weights(fn, _layout_lambda(V, extra)(params))

    take, done = _tokens(kind, [n, V, L, C, nFeat, nDepth, hasWL, seed, fn,
                                "grad"])
    pg = prep.prepare_graph(mol, L, V, None, nDepth,
                            has_WL_ordering=bool(hasWL), dtype=np.float64)
    sizes = np.asarray(pg.sizes)
    n_fwd = 0
    for l in range(L + 1):
        Cl = cfg.channels_at(l)
        for v in range(n):
            n_fwd += 1 + (int(sizes[l, v]) if l else 1) * Cl
    n_fwd += cfg.channels_at(L) + 1
    take(n_fwd)

    g = _g64(pg)

    def loss(p):
        pred, _ = smp1d_forward(p, g, cfg)
        return losses.squared_loss(pred, jnp.float64(3.5))

    grads = jax.grad(loss)(params)
    named = [("H", grads["H"])]
    for l in range(L):
        lev = grads["levels"][l]
        for s in range(1, V + 1):
            named += [(f"l{l}/lambda1[{s}]", lev["lambda1"][s:s + 1]),
                      (f"l{l}/lambda2[{s}]", lev["lambda2"][s:s + 1]),
                      (f"l{l}/b[{s}]", lev["b"][s])]
        for k in extra:
            named.append((f"l{l}/{k}", lev[k]))
    named.append(("W", grads["W"]))
    for name, got in named:
        got = np.asarray(got)
        ref = take(got.size).reshape(got.shape)
        np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-10,
                                   err_msg=f"grad {name}")
    done()
