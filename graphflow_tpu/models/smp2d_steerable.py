"""Steerable-filter second-order SMP family (SMP_2D base + variants).

Covers the reference models that predate the contraction banks:

  SMP_2D (``SMP_2D.h:523-580``): vertex tensor update
      q_v   = SUM_{w: sp(v,w)<=1} X f_w X^T  +  scalar (.) adj_v
      out_v = LeakyReLU(W[s] (*) q_v + b[s]),
      W[s] = lambda1[s] (.) I_s + lambda2[s] (.) 1_s  (C-vector lambdas per
      receptive-field SIZE; (*) is per-depth spatial matmul TensorMul,
      (.) channel-broadcast VectorBroadcastMat).  Momentum.
  SMP_2D_classification: + LogLoss head.
  SMP_2D_ver2/ver3 (``SMP_2D_ver2.h:131-177``): MATRIX-valued lambdas
      (prevC x prevC) with channel growth C_l = 2 C_{l-1}
      (Tensor4DConcat of the two filter paths, Tensor4DTensor3DMul apply);
      ver3 drops the scalar (.) adjacency addition (``SMP_2D_ver3.h:551``).
  SMP_2D_ver4(_cls) (``SMP_2D_ver4.h:130-180``): vector lambdas, the two
      filter paths concatenated along channels — channel growth, no reducer.
  SMP_2D_ver5 (``SMP_2D_ver5.h:127-171``): like ver4 but constant width —
      the 2C concat is reduced by K (C x 2C) (CustomMatMulTensor at
      ``SMP_2D_ver5.h:599-604``).
  Unrestricted_SMP_2D (``Unrestricted_SMP_2D.h:99-124``): a full learned
      W[s] in R^{s x s x C} applied by TensorMul.
  Unrestricted_SMP_2D_ver2 (``Unrestricted_SMP_2D_ver2.h:102-137``):
      channel growth C_l = 2 C_{l-1} with a full 4-D filter
      W[s] in R^{s x s x prevC x C} applied by Tensor4DTensor3DMul
      (out[p,q,d] = SUM_{k,c} W[p,k,c,d] q[k,q,c]).

The steerable structure lets every filter apply collapse to closed forms —
W[s] (*) q = lambda1 (.) q + lambda2 (.) (rowsum broadcast) — so no dense
filter tensors are materialized on device.

The neighbor aggregation is the second-order analog of smp1d's
vertex-id-space matmul: states are scattered to G[w, u1, u2, c], the 1-hop
sum becomes one einsum over w, and results are gathered into each phi's
local ordering with the sentinel convention.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from graphflow_tpu.core import prep
from graphflow_tpu.core.graph import DenseGraph
from graphflow_tpu.models.base import GraphModel
from graphflow_tpu.ops import activations, losses


@dataclasses.dataclass
class SMP2DSteerableConfig:
    max_nVertices: int
    nLevels: int
    nChanels: int
    nFeatures: int
    nDepth: int
    # "steerable"    — W = l1 (.) I + l2 (.) 1, constant channels (SMP_2D.h)
    # "matrix"       — matrix lambdas (prevC x prevC), concat, channel growth
    #                  (SMP_2D_ver2.h/ver3.h)
    # "concat"       — vector lambdas, concat, channel growth (SMP_2D_ver4.h:
    #                  nChanels doubles per level, no reducer)
    # "concat_k"     — vector lambdas, concat, K (C x 2C) reducer, constant
    #                  channels (SMP_2D_ver5.h:127-171)
    # "unrestricted" / "unrestricted4d" — full learned filters
    filter: str = "steerable"
    has_WL_ordering: bool = True
    # ver3 drops the scalar (.) reduced-adjacency addition that ver2 keeps
    # (diff SMP_2D_ver2.h:548-576 vs SMP_2D_ver3.h:551 — ver3's affine
    # consumes level->sum directly and registers no scalar parameter).
    add_scalar_adj: bool = True
    # The reference has TWO reduced-adjacency diagonal conventions
    # (uncovered by the round-4 binary-parity harness): SMP_2D /
    # _classification / ver2 / Unrestricted(+ver2) copy the raw adjacency
    # (diagonal 0, ``SMP_2D.h:458-469``), while ver4/ver5 (and the
    # omega/beta/contraction families) force the diagonal to 1
    # (``SMP_2D_ver4.h:488-493``).  prep builds the forced-1 form; with
    # False the diagonal is restored to the raw adjacency's.
    radj_self_loops: bool = True
    # ver4(_cls)/ver5 additionally ROW-NORMALIZE the (diag-1) reduced
    # adjacency: each row is divided by its row sum, i.e. the closed
    # degree within phi (``SMP_2D_ver4.h:481-502``) — a third reference
    # convention, also uncovered by the binary-parity harness.
    radj_row_normalize: bool = False
    # ver2/ver3 and Unrestricted_ver2 register their Tensor4DTensor3DMul
    # affine under the TENSORMUL opcode (``SMP_2D_ver2.h:588``,
    # ``Unrestricted_SMP_2D_ver2.h:537``); GraphFlow's dispatcher C-casts
    # the node and calls the NON-virtual ``TensorMul::forward``
    # (``GraphFlow.h:615-620``), which reinterprets the 4-D filter's flat
    # buffer through 3-D strides.  The shipped binaries therefore compute
    #   out[i,j,d] = SUM_k Wflat[(i*s+k)*prevC + d] * qflat[(k*s+j)*prevC + d]
    # — a scrambled prefix read of the filter parameters plus out-of-view
    # q reads that land in never-written (zero) heap — NOT the
    # Tensor4DTensor3DMul contraction the graph declares.  Verified
    # deterministic (identical under MALLOC_PERTURB_) and binary-pinned in
    # tests/test_model_parity3.py.  True (default) reproduces the executed
    # behavior; False computes the declared spec.
    engine_faithful: bool = True
    # Reproduce the reference's SHARED-NODE lambda gradients (prefix-sum
    # overcounting over same-size vertices — see
    # activations.persize_gather_refgrad); False = true gradients.
    faithful_lambda_grads: bool = True
    nClasses: Optional[int] = None
    optimizer: str = "momentum"
    momentum_param: float = 0.9
    dtype: str = "float32"

    @property
    def feat_dim(self):
        return self.nFeatures * (self.nDepth + 1)

    def channels_at(self, l: int) -> int:
        """ver2/ver3/ver4 double channels per level (SMP_2D_ver2.h:131,
        SMP_2D_ver4.h:130-138); Unrestricted ver2 likewise
        (Unrestricted_SMP_2D_ver2.h:102-104)."""
        if self.filter in ("matrix", "concat", "unrestricted4d"):
            return self.nChanels * (2 ** l)
        return self.nChanels

    @property
    def P(self):
        return self.max_nVertices  # these models are uncapped


def init_params(key, cfg: SMP2DSteerableConfig):
    from graphflow_tpu.optim.utils import uniform_init

    V1 = cfg.max_nVertices + 1
    dtype = jnp.dtype(cfg.dtype)
    keys = iter(jax.random.split(key, 6 * cfg.nLevels + 3))
    params = {"H": uniform_init(next(keys), (cfg.nChanels, cfg.feat_dim),
                                dtype),
              "levels": []}
    for l in range(1, cfg.nLevels + 1):
        C_prev, C = cfg.channels_at(l - 1), cfg.channels_at(l)
        # Reference uniform_init scales vectors by their size
        # (GraphFlow.h:1297-1307), so lambda/scalar ranges are 0.9/C.
        lev = {}
        if cfg.add_scalar_adj:
            lev["scalar"] = uniform_init(next(keys), (C_prev,), dtype,
                                         fan=C_prev)
        if cfg.filter == "unrestricted":
            lev["Wf"] = uniform_init(next(keys), (V1, cfg.P, cfg.P, C),
                                     dtype, fan=cfg.P)
        elif cfg.filter == "unrestricted4d":
            lev["Wf"] = uniform_init(
                next(keys), (V1, cfg.P, cfg.P, C_prev, C), dtype, fan=cfg.P)
        elif cfg.filter == "matrix":
            lev["lambda1"] = uniform_init(next(keys), (V1, C_prev, C_prev),
                                          dtype, fan=C_prev)
            lev["lambda2"] = uniform_init(next(keys), (V1, C_prev, C_prev),
                                          dtype, fan=C_prev)
        elif cfg.filter == "concat":
            # ver4: vector lambdas over the PREVIOUS level's channels
            # (SMP_2D_ver4.h:149-150: Vector(prevC)).
            lev["lambda1"] = uniform_init(next(keys), (V1, C_prev), dtype,
                                          fan=C_prev)
            lev["lambda2"] = uniform_init(next(keys), (V1, C_prev), dtype,
                                          fan=C_prev)
        else:
            lev["lambda1"] = uniform_init(next(keys), (V1, C), dtype, fan=C)
            lev["lambda2"] = uniform_init(next(keys), (V1, C), dtype, fan=C)
        if cfg.filter == "concat_k":
            lev["K"] = uniform_init(next(keys), (C, 2 * C), dtype)
        lev["b"] = uniform_init(next(keys), (V1, C), dtype, fan=C)
        params["levels"].append(lev)
    CL = cfg.channels_at(cfg.nLevels)
    if cfg.nClasses:
        params["W"] = uniform_init(next(keys), (cfg.nClasses, CL), dtype)
    else:
        params["W"] = uniform_init(next(keys), (CL,), dtype)
    return params


# Every einsum of the neighbor sum has a 0/1 selection or adjacency
# operand: HIGHEST keeps its f32 sums exact where the default precision
# may round the values to TF32 on the GPU.
_ein = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


def _qsum_block(state_b, selp_b, adj_b):
    """Id-space scatter + adjacency contraction for one block of source
    vertices: returns sum_{w in block} adj[:, w] (.) (X_w f_w X_w^T)."""
    G = _ein("wqu,wqrc->wurc", selp_b, state_b)            # [B, V, Pp, C]
    G = _ein("wrt,wurc->wutc", selp_b, G)                  # [B, V, V, C]
    return _ein("vw,wxyc->vxyc", adj_b, G)                 # [V, V, V, C]


def _neighbor_quadratic_sum(state, vid_prev, adj1, vid_cur, V, Pp, C,
                            block: int = 8):
    """SUM_{w in 1-hop(v)} X f_w X^T for every v, vectorized.

    state: [V, Pp, Pp, C] previous level, vid_prev[w, q] = phi_{l-1}(w)[q]
    (sentinel V), adj1 closed 1-hop [V, V], vid_cur[v, p] (sentinel V).

    Memory: the uncapped second-order state is inherently O(V Pp^2 C) with
    Pp = V (the reference SMP_2D keeps a |phi| x |phi| x C Tensor3D per
    vertex with |phi| up to V — ``SMP_2D.h:523-580`` — same asymptotic);
    what this implementation bounds is the CONSTANT: the per-w id-space
    scatters G[w, V, V, C] are accumulated into the aggregate M over
    ``block``-sized source chunks under ``lax.scan``, so the peak live set
    is one aggregate + one chunk instead of three full [V, V, V, C]
    tensors, and the whole sum is rematerialized (``jax.checkpoint`` at
    the call site) so the backward pass stores only the level inputs.
    """
    # Scatter to vertex-id space via one-hot matmuls (sentinel V falls
    # outside the iota range -> zero selector row).
    dt = state.dtype
    selp = (vid_prev[:, :, None] == jnp.arange(V)).astype(dt)   # [V, Pp, V]
    while V % block:
        block -= 1
    if block >= V:
        M = _qsum_block(state, selp, adj1)
    else:
        nb = V // block

        def body(M, xs):
            state_b, selp_b, adj_b = xs
            return M + _qsum_block(state_b, selp_b, adj_b), None

        xs = (state.reshape(nb, block, Pp, Pp, C),
              selp.reshape(nb, block, Pp, V),
              jnp.moveaxis(adj1.reshape(V, nb, block), 1, 0))
        M, _ = jax.lax.scan(body, jnp.zeros((V, V, V, C), dt), xs)
    # Gather into phi_l(v)'s ordering (one-hot matmuls).
    selc = (vid_cur[:, :, None] == jnp.arange(V)).astype(dt)    # [V, Pp, V]
    out = _ein("vpx,vxyc->vpyc", selc, M)
    return _ein("vqy,vpyc->vpqc", selc, out)                    # [V, Pp, Pp, C]


@functools.lru_cache(maxsize=32)
def _tensormul_cast_tables(V: int, P: int, prevC: int):
    """Index tables reproducing GraphFlow's TENSORMUL dispatch of a
    Tensor4DTensor3DMul node (see SMP2DSteerableConfig.engine_faithful).

    For a receptive field of size s the executed affine is
      out[i,j,d] = SUM_{k<s} Wflat[(i*s+k)*prevC + d]
                           * qflat[(k*s+j)*prevC + d],   d < D = 2*prevC,
    where both flat indices are decoded in the COMPACT (s, s, ...) layouts
    (TensorMul::forward reads the Tensor4D's nChanels1 through Tensor3D's
    nDepth field offset).  All tables are stacked over sizes s = 0..V and
    shaped [V+1, P, P, D]; indices are clipped in-range with separate
    validity masks (invalid reads contribute zero — matching the
    fresh-heap zeros the binary reads past the current view).
    """
    D = 2 * prevC
    shape = (V + 1, P, P, D)
    w_x = np.zeros(shape, np.int32); w_y = np.zeros(shape, np.int32)
    w_cw = np.zeros(shape, np.int32); w_dw = np.zeros(shape, np.int32)
    w_iseye = np.zeros(shape, bool); w_diag = np.zeros(shape, bool)
    a_ok = np.zeros(shape, bool)
    q_row = np.zeros(shape, np.int32); q_col = np.zeros(shape, np.int32)
    q_ok = np.zeros(shape, bool)
    i = np.arange(P)[:, None, None]
    k = np.arange(P)[None, :, None]
    d = np.arange(D)[None, None, :]
    for s in range(1, V + 1):
        # W read: m = (i*s+k)*prevC + d decoded in the compact
        # (s, s, prevC, D) Tensor4D layout m = ((x*s+y)*prevC + cw)*D + dw.
        m = (i * s + k) * prevC + d
        a, dw = m // D, m % D
        cw, xy = a % prevC, a // prevC
        x, y = xy // s, xy % s
        w_x[s], w_y[s] = np.minimum(x, P - 1), np.minimum(y, P - 1)
        w_cw[s], w_dw[s] = cw, dw
        w_iseye[s] = dw < prevC
        w_diag[s] = np.where(dw < prevC, x == y, True)
        a_ok[s] = (i < s) & (k < s) & (x < s)
        # q read: mq = (k*s+j)*prevC + d decoded in the compact
        # (s, s, prevC) layout; t2 >= s*s falls past the view -> zero.
        t2 = i * s + k + d // prevC          # first axis plays k, second j
        q_row[s] = np.minimum(t2 // s, P - 1)
        q_col[s] = np.minimum(t2 % s, P - 1)
        q_ok[s] = (i < s) & (k < s) & (t2 < s * s)
    ccol = (np.arange(D) % prevC).astype(np.int32)
    return dict(w_x=w_x, w_y=w_y, w_cw=w_cw, w_dw=w_dw, w_iseye=w_iseye,
                w_diag=w_diag, a_ok=a_ok, q_row=q_row, q_col=q_col,
                q_ok=q_ok, ccol=ccol)


def _tensormul_cast_gather_q(q, tb, s, V, dt):
    """Qx[v,k,j,d] = q[v, row, col, d % prevC] under the cast decode."""
    vi = jnp.arange(V)[:, None, None, None]
    q_row = jnp.asarray(tb["q_row"])[s]
    q_col = jnp.asarray(tb["q_col"])[s]
    q_ok = jnp.asarray(tb["q_ok"])[s].astype(dt)
    ccol = jnp.asarray(tb["ccol"])[None, None, None, :]
    return q[vi, q_row, q_col, ccol] * q_ok


def _tensormul_cast_matrix_filter(q, L1, L2, s, V, P, prevC):
    """As-executed ver2/ver3 filter: W built from matrix lambdas
    (W_eye = eye (x) L1, W_one = one (x) L2, ``SMP_2D_ver2.h:577-585``)
    then consumed through the TENSORMUL cast."""
    dt = q.dtype
    tb = _tensormul_cast_tables(V, P, prevC)
    vi = jnp.arange(V)[:, None, None, None]
    cw, dwc = jnp.asarray(tb["w_cw"])[s], jnp.asarray(tb["w_dw"])[s] % prevC
    A1 = L1[vi, cw, dwc]
    A2 = L2[vi, cw, dwc]
    iseye = jnp.asarray(tb["w_iseye"])[s]
    diag = jnp.asarray(tb["w_diag"])[s].astype(dt)
    a_ok = jnp.asarray(tb["a_ok"])[s].astype(dt)
    A = jnp.where(iseye, diag * A1, A2) * a_ok            # [V, P, P, D]
    Qx = _tensormul_cast_gather_q(q, tb, s, V, dt)
    return jnp.einsum("vikd,vkjd->vijd", A, Qx)


def _tensormul_cast_full_filter(q, Wsel, s, V, P, prevC):
    """As-executed Unrestricted_ver2 filter: the learned per-size Tensor4D
    W[s] (s, s, prevC, C) consumed through the TENSORMUL cast
    (``Unrestricted_SMP_2D_ver2.h:531-537``)."""
    dt = q.dtype
    tb = _tensormul_cast_tables(V, P, prevC)
    vi = jnp.arange(V)[:, None, None, None]
    A = Wsel[vi, jnp.asarray(tb["w_x"])[s], jnp.asarray(tb["w_y"])[s],
             jnp.asarray(tb["w_cw"])[s], jnp.asarray(tb["w_dw"])[s]]
    A = A * jnp.asarray(tb["a_ok"])[s].astype(dt)
    Qx = _tensormul_cast_gather_q(q, tb, s, V, dt)
    return jnp.einsum("vikd,vkjd->vijd", A, Qx)


def steerable_states(params, g, cfg: SMP2DSteerableConfig,
                     collect_presum=None):
    """Run the tower, returning the per-level vertex tensor states (list of
    [V, Pp, Pp, C_l] — the reference's ``level[l]->f[v]`` activations, for
    binary-parity tests and ForDebugging-style dumps).

    ``collect_presum``: optional list; when given, the per-level pre-filter
    aggregate (the reference's ``quadratic_plus_adj[v]`` — or bare
    ``sum[v]`` when add_scalar_adj is off) is appended per level."""
    V, Pp = cfg.max_nVertices, cfg.P

    C0 = cfg.nChanels
    F0 = activations.leaky_relu(g["wl_feat"] @ params["H"].T)     # [V, C0]
    state = jnp.zeros((V, Pp, Pp, C0), F0.dtype).at[:, 0, 0, :].set(
        F0 * g["vmask"][:, None])
    states = [state]
    vid_prev = jnp.full((V, Pp), V, jnp.int32).at[:, 0].set(
        jnp.arange(V, dtype=jnp.int32))

    adj1 = jnp.minimum(g["adj"] + jnp.eye(V, dtype=g["adj"].dtype), 1.0)
    adj1 = adj1 * g["vmask"][:, None] * g["vmask"][None, :]

    for l in range(cfg.nLevels):
        lev = params["levels"][l]
        C_prev, C = cfg.channels_at(l), cfg.channels_at(l + 1)
        rm = g["smask"][l + 1][:, :, 0]                        # [V, Pp]
        vid_cur = jnp.where(rm > 0, g["nbr"][l].astype(jnp.int32), V)
        s = g["sizes"][l + 1]
        if "lambda1" in lev:
            if cfg.faithful_lambda_grads:
                # lambda -> W_eye [-> W] shared-node chain depth
                # (SMP_2D.h:556-570 depth 2, SMP_2D_ver2.h:577-585 depth
                # 2, ver4/ver5 depth 1).
                depth = {"steerable": 2, "matrix": 2, "concat": 1,
                         "concat_k": 1}[cfg.filter]
                lam1 = activations.persize_gather_refgrad(
                    lev["lambda1"], s, depth)
                lam2 = activations.persize_gather_refgrad(
                    lev["lambda2"], s, depth)
            else:
                lam1, lam2 = lev["lambda1"][s], lev["lambda2"][s]

        # Rematerialized: the backward recomputes the quadratic sum instead
        # of holding its O(V^3 C) intermediates as residuals.
        q = jax.checkpoint(_neighbor_quadratic_sum, static_argnums=(4, 5, 6))(
            state, vid_prev, adj1, vid_cur, V, Pp, C_prev)
        if cfg.add_scalar_adj:
            # + scalar (.) reduced adjacency (SMP_2D.h:528-530); ver3 omits
            # this term (SMP_2D_ver3.h:551).
            q = q + (g["radj"][l][:, :, :, None]
                     * lev["scalar"][None, None, None])
        q = q * g["smask"][l + 1][:, :, :, None]
        if collect_presum is not None:
            collect_presum.append(q)

        # Row-broadcast column sums: (1_s @ M)[p1, p2] = sum_p M[p, p2]
        colsum = q.sum(axis=1)                                 # [V, Pp, C_prev]
        ones_q = rm[:, :, None, None] * colsum[:, None, :, :]  # [V,Pp,Pp,Cp]

        if cfg.filter == "steerable":
            l1, l2 = lam1, lam2                                # [V, C]
            z = (l1[:, None, None, :] * q + l2[:, None, None, :] * ones_q)
        elif cfg.filter == "concat":
            # ver4 (SMP_2D_ver4.h:166-180): vector-lambda branches
            # concatenated, channels double, no reducer.
            l1, l2 = lam1, lam2                                # [V, C_prev]
            z = jnp.concatenate(
                [l1[:, None, None, :] * q, l2[:, None, None, :] * ones_q],
                axis=-1)                                       # [V,Pp,Pp,2Cp]
        elif cfg.filter == "concat_k":
            l1, l2 = lam1, lam2
            cat = jnp.concatenate(
                [l1[:, None, None, :] * q, l2[:, None, None, :] * ones_q],
                axis=-1)                                       # [V,Pp,Pp,2C]
            z = jnp.einsum("kw,vxyw->vxyk", lev["K"], cat)     # K(2C->C)
        elif cfg.filter == "matrix":
            L1, L2 = lam1, lam2                                # [V, Cp, Cp]
            if cfg.engine_faithful:
                # What the ver2/ver3 binaries actually execute (the
                # TENSORMUL cast — see engine_faithful).
                z = _tensormul_cast_matrix_filter(q, L1, L2, s, V, Pp,
                                                  C_prev)
            else:
                # The Tensor4DTensor3DMul contraction the graph declares.
                p1 = jnp.einsum("vxyc,vcd->vxyd", q, L1)
                p2 = jnp.einsum("vxyc,vcd->vxyd", ones_q, L2)
                z = jnp.concatenate([p1, p2], axis=-1)         # [V,..,2 Cp]
        elif cfg.filter == "unrestricted":
            Wv = lev["Wf"][s]                                  # [V, Pp, Pp, C]
            Wv = Wv * g["smask"][l + 1][:, :, :, None]
            z = jnp.einsum("vpqc,vqrc->vprc", Wv, q)
        elif cfg.filter == "unrestricted4d":
            Wv = lev["Wf"][s]                            # [V, Pp, Pp, Cp, C]
            if cfg.engine_faithful:
                # What the Unrestricted_ver2 binary actually executes
                # (the TENSORMUL cast — see engine_faithful).
                z = _tensormul_cast_full_filter(q, Wv, s, V, Pp, C_prev)
            else:
                # Tensor4DTensor3DMul.h:49-71 spec: out[p,q,d] =
                # SUM_kc W[p,k,c,d] q[k,q,c]; W[s] grows prevC -> C.
                Wv = Wv * g["smask"][l + 1][:, :, :, None, None]
                z = jnp.einsum("vpkcd,vkqc->vpqd", Wv, q)
        else:
            raise ValueError(cfg.filter)

        z = z + lev["b"][s][:, None, None, :]
        state = activations.leaky_relu(z)
        state = state * g["smask"][l + 1][:, :, :, None]
        states.append(state)
        vid_prev = vid_cur
    return states


def forward(params, g, cfg: SMP2DSteerableConfig):
    state = steerable_states(params, g, cfg)[-1]
    vertex = activations.leaky_relu(state.sum(axis=(1, 2)))
    graph_feat = (vertex * g["vmask"][:, None]).sum(axis=0)
    if cfg.nClasses:
        return params["W"] @ graph_feat, graph_feat
    return jnp.dot(graph_feat, params["W"]), graph_feat


def strip_radj_self_loops(pg, graph: DenseGraph):
    """Replace the prepared reduced adjacency's forced-1 diagonal with the
    raw adjacency's own diagonal entries (the SMP_2D-family convention,
    ``SMP_2D.h:458-469`` — see SMP2DSteerableConfig.radj_self_loops)."""
    import dataclasses as _dc

    radj = np.array(pg.radj)                     # [L, V, P, P]
    L, V, Pp = radj.shape[0], radj.shape[1], radj.shape[2]
    nbr = np.asarray(pg.nbr)                     # [L, V, P]
    sizes = np.asarray(pg.sizes)                 # [L+1, V]
    adiag = np.zeros(V + 1)
    n = graph.nVertices
    adiag[:n] = np.diagonal(graph.adj)
    idx = np.arange(Pp)
    valid = idx[None, None, :] < sizes[1:, :, None]      # [L, V, P]
    diag_vals = adiag[np.minimum(nbr, V)] * valid
    radj[:, :, idx, idx] = diag_vals
    return _dc.replace(pg, radj=radj.astype(pg.radj.dtype))


def row_normalize_radj(pg):
    """Row-normalize each reduced-adjacency block by its row sums (the
    closed degree within phi) — the ver4/ver5 convention
    (``SMP_2D_ver4.h:481-502``)."""
    import dataclasses as _dc

    radj = np.array(pg.radj, np.float64)
    rowsum = radj.sum(axis=3, keepdims=True)
    radj = np.where(rowsum > 0, radj / np.where(rowsum == 0, 1.0, rowsum),
                    radj)
    return _dc.replace(pg, radj=radj.astype(pg.radj.dtype))


class SMP2DSteerable(GraphModel):
    def __init__(self, cfg: SMP2DSteerableConfig, seed: int = 0):
        kwargs = ({"gamma": cfg.momentum_param}
                  if cfg.optimizer == "momentum" else {})
        super().__init__(optimizer=cfg.optimizer, **kwargs)
        self.cfg = cfg
        self.params = init_params(jax.random.PRNGKey(seed), cfg)
        self._finish_init()

    def _prepare(self, graph: DenseGraph):
        pg = prep.prepare_graph(
            graph, self.cfg.nLevels, self.cfg.max_nVertices,
            max_receptive_field=None, nDepth=self.cfg.nDepth,
            has_WL_ordering=self.cfg.has_WL_ordering,
            dtype=np.dtype(self.cfg.dtype))
        if not self.cfg.radj_self_loops:
            pg = strip_radj_self_loops(pg, graph)
        if self.cfg.radj_row_normalize:
            pg = row_normalize_radj(pg)
        return pg

    def _forward(self, params, g):
        return forward(params, g, self.cfg)

    def _loss(self, params, g, target):
        out, _ = forward(params, g, self.cfg)
        if self.cfg.nClasses:
            return losses.log_loss(out, target.astype(jnp.int32))
        return losses.squared_loss(out, target)


# ----------------------------------------------------------------------
# Named constructors mirroring the reference classes
# ----------------------------------------------------------------------

def SMP_2D(max_nVertices, nLevels, nChanels, nFeatures, nDepth,
           momentum_param=0.9, has_WL_ordering=True, seed=0):
    """``SMP_2D.h``."""
    return SMP2DSteerable(SMP2DSteerableConfig(
        max_nVertices, nLevels, nChanels, nFeatures, nDepth,
        filter="steerable", has_WL_ordering=has_WL_ordering,
        radj_self_loops=False, momentum_param=momentum_param), seed)


def SMP_2D_classification(max_nVertices, nLevels, nChanels, nFeatures,
                          nDepth, nClasses, momentum_param=0.9, seed=0):
    """``SMP_2D_classification.h``."""
    return SMP2DSteerable(SMP2DSteerableConfig(
        max_nVertices, nLevels, nChanels, nFeatures, nDepth,
        filter="steerable", nClasses=nClasses, radj_self_loops=False,
        momentum_param=momentum_param), seed)


def SMP_2D_ver2(max_nVertices, nLevels, nChanels, nFeatures, nDepth,
                momentum_param=0.9, seed=0):
    """``SMP_2D_ver2.h``: matrix lambdas, channel growth x2 per level,
    scalar (.) reduced-adjacency term (``SMP_2D_ver2.h:548-576``).
    The shipped binary's filter apply goes through the TENSORMUL cast
    (see SMP2DSteerableConfig.engine_faithful) — reproduced by default,
    binary-pinned in tests/test_model_parity3.py."""
    return SMP2DSteerable(SMP2DSteerableConfig(
        max_nVertices, nLevels, nChanels, nFeatures, nDepth,
        filter="matrix", radj_self_loops=False,
        momentum_param=momentum_param), seed)


def SMP_2D_ver3(max_nVertices, nLevels, nChanels, nFeatures, nDepth,
                momentum_param=0.9, seed=0):
    """``SMP_2D_ver3.h``: ver2 WITHOUT the scalar (.) adjacency addition —
    the filter consumes the bare quadratic sum (``SMP_2D_ver3.h:551``; ver2
    adds quadratic_plus_adj at ``SMP_2D_ver2.h:570-587``).  Same TENSORMUL
    cast as ver2 (see SMP2DSteerableConfig.engine_faithful)."""
    return SMP2DSteerable(SMP2DSteerableConfig(
        max_nVertices, nLevels, nChanels, nFeatures, nDepth,
        filter="matrix", add_scalar_adj=False,
        momentum_param=momentum_param), seed)


def SMP_2D_ver4(max_nVertices, nLevels, nChanels, nFeatures, nDepth,
                momentum_param=0.9, seed=0):
    """``SMP_2D_ver4.h:130-180``: vector lambdas, the two filter branches
    concatenated with CHANNEL GROWTH (C_l = 2 C_{l-1}); no reducer."""
    return SMP2DSteerable(SMP2DSteerableConfig(
        max_nVertices, nLevels, nChanels, nFeatures, nDepth,
        filter="concat", radj_row_normalize=True,
        momentum_param=momentum_param), seed)


def SMP_2D_ver4_classification(max_nVertices, nLevels, nChanels, nFeatures,
                               nDepth, nClasses, momentum_param=0.9, seed=0):
    """``SMP_2D_ver4_classification.h``."""
    return SMP2DSteerable(SMP2DSteerableConfig(
        max_nVertices, nLevels, nChanels, nFeatures, nDepth,
        filter="concat", nClasses=nClasses, radj_row_normalize=True,
        momentum_param=momentum_param), seed)


def SMP_2D_ver5(max_nVertices, nLevels, nChanels, nFeatures, nDepth,
                momentum_param=0.9, seed=0):
    """``SMP_2D_ver5.h:127-171``: vector lambdas, concat then K (C x 2C)
    channel reducer (CustomMatMulTensor at ``SMP_2D_ver5.h:599-604``) —
    constant channel width."""
    return SMP2DSteerable(SMP2DSteerableConfig(
        max_nVertices, nLevels, nChanels, nFeatures, nDepth,
        filter="concat_k", radj_row_normalize=True,
        momentum_param=momentum_param), seed)


def Unrestricted_SMP_2D(max_nVertices, nLevels, nChanels, nFeatures, nDepth,
                        momentum_param=0.9, seed=0):
    """``Unrestricted_SMP_2D.h``: full learned W[s] filter tensors."""
    return SMP2DSteerable(SMP2DSteerableConfig(
        max_nVertices, nLevels, nChanels, nFeatures, nDepth,
        filter="unrestricted", radj_self_loops=False,
        momentum_param=momentum_param), seed)


def Unrestricted_SMP_2D_ver2(max_nVertices, nLevels, nChanels, nFeatures,
                             nDepth, momentum_param=0.9, seed=0):
    """``Unrestricted_SMP_2D_ver2.h``: 4-D W[s] filters, channel growth.
    The filter apply goes through the same TENSORMUL cast as SMP_2D_ver2
    (see SMP2DSteerableConfig.engine_faithful)."""
    return SMP2DSteerable(SMP2DSteerableConfig(
        max_nVertices, nLevels, nChanels, nFeatures, nDepth,
        filter="unrestricted4d", radj_self_loops=False,
        momentum_param=momentum_param), seed)
