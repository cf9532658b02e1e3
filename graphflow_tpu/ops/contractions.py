"""Permutation-covariant tensor contraction banks (RisiContraction 4/10/18/50).

These are the flagship kernels of the CCN "Steerable Message Passing" models:
given N stacked vertex tensors T[a, b, c, f] (the a-axis indexes the stacked
neighbor tensors) and a reduced adjacency A[d, e], each contraction case fixes
two of the five indices (a,b,c,d,e), ties/contracts the rest, and emits an
[N, N, C] slab; the bank concatenates the cases along the channel axis.

Reference implementations (scalar loops / CUDA gather kernels):
  RisiContraction_4.h:79-124   (4 cases, no adjacency)
  RisiContraction_10.h:94-...  (10 "fix 2, contract 3" cases of T.A)
  RisiContraction_18.h:73-331  (the 18-case flagship; the `adj_value > 0`
                               guard at :90 drops non-positive adjacency)
  RisiContraction_50.h:94-...  (all 50 index-partition patterns)
  RisiContraction_18_gpu.h     (CUDA gather formulation)

Design: every case collapses to an einsum over a small set of
*shared reductions* of T and A.  This removes the |E| factor from the
reference's scatter loops — the whole 18-case bank costs O(N^3 C) instead of
O(|E| N^3 C) — and compiles to a handful of fused contractions.
The generic case-table engine below is the executable specification (used by
the parity tests); `risi_contraction_18` is the hand-optimized production
path with shared reductions.

All functions take one (T, A) pair; batch with `jax.vmap` (the models do).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

nContractions_4 = 4
nContractions_10 = 10
nContractions_18 = 18
nContractions_50 = 50

# ----------------------------------------------------------------------
# Generic case-table engine (executable specification)
# ----------------------------------------------------------------------

_PAIRS: Tuple[Tuple[str, str], ...] = (
    ("a", "b"), ("a", "c"), ("a", "d"), ("a", "e"), ("b", "c"),
    ("b", "d"), ("b", "e"), ("c", "d"), ("c", "e"), ("d", "e"),
)


def _case_table_50():
    """The 50 cases in the reference's order (RisiContraction_50.h:94-431).

    Cases 1-10: fix each pair, contract the other three independently.
    Cases 11-40: fix each pair; tie each lexicographic pair of the rest.
    Cases 41-50: fix each pair; tie all three of the rest.
    Each entry: (fixed_pair, tie_group or None).
    """
    table = [(p, None) for p in _PAIRS]
    for p in _PAIRS:
        rest = [i for i in "abcde" if i not in p]
        for t in ((rest[0], rest[1]), (rest[0], rest[2]), (rest[1], rest[2])):
            table.append((p, t))
    for p in _PAIRS:
        rest = tuple(i for i in "abcde" if i not in p)
        table.append((p, rest))
    return tuple(table)


_TABLE_50 = _case_table_50()

# The 18-case subset, by 1-based position in the 50-case table
# (the "(k/50)" comments in RisiContraction_18.h:103-319).
_SUBSET_18 = (1, 3, 5, 6, 10, 11, 13, 17, 18, 23, 26, 27, 28, 38, 40, 43, 46, 50)


def _case_einsum(T, A, fixed, tie):
    """One contraction case as an einsum of T[a,b,c,f] and A[d,e]."""
    sym = {i: i for i in "abcde"}
    if tie is not None:
        for i in tie[1:]:
            sym[i] = tie[0]
    t_sub = sym["a"] + sym["b"] + sym["c"] + "f"
    a_sub = sym["d"] + sym["e"]
    out = sym[fixed[0]] + sym[fixed[1]] + "f"
    return jnp.einsum(f"{t_sub},{a_sub}->{out}", T, A)


def _contract_cases(T, A, cases: Sequence[int]):
    """Run selected (1-based) 50-table cases and concat along channels."""
    outs = [_case_einsum(T, A, *_TABLE_50[c - 1]) for c in cases]
    return jnp.concatenate(outs, axis=-1)


# ----------------------------------------------------------------------
# Public contraction banks
# ----------------------------------------------------------------------

def risi_contraction_4(T):
    """``RisiContraction_4.h:79-124``: 4 contractions of T[a,b,c,f], no
    adjacency: (a,b)/sum c; (b,c)/sum a; diag a==b; diag b==c."""
    y1 = T.sum(axis=2)                      # Case 1: fix (a,b), contract c
    y2 = T.sum(axis=0)                      # Case 2: fix (b,c), contract a
    y3 = jnp.einsum("aacf->acf", T)         # Case 3: (a==b, c)
    y4 = jnp.einsum("abbf->abf", T)         # Case 4: (a, b==c)
    return jnp.concatenate([y1, y2, y3, y4], axis=-1)


def risi_contraction_10_spec(T, A):
    """Generic-engine specification of the 10-case bank (tests)."""
    return _contract_cases(T, A, range(1, 11))


def risi_contraction_50_spec(T, A):
    """Generic-engine specification of the 50-case bank (tests)."""
    return _contract_cases(T, A, range(1, 51))


def _shared_reductions(T, A):
    """All shared T/A reductions the 10/50-case banks are assembled from.

    Mirrors :func:`risi_contraction_18`'s decomposition, completed for the
    full index-partition table (``RisiContraction_50.h:94-431``): every
    case becomes a scalar*slab, a vector outer product u[x]*v[y], or one
    [N,N,C]x[N,N] matmul — O(N^3 C) total, no |E| factor.
    """
    S = A.sum()
    R = A.sum(axis=1)                       # [d]
    Rc = A.sum(axis=0)                      # [e]
    trA = jnp.trace(A)
    diagA = jnp.diagonal(A)                 # [N]

    T_ab = T.sum(axis=2)                    # [a,b,f]
    T_ac = T.sum(axis=1)                    # [a,c,f]
    T_bc = T.sum(axis=0)                    # [b,c,f]
    T_a = T_ab.sum(axis=1)                  # [a,f]
    T_b = T_ab.sum(axis=0)                  # [b,f]
    T_c = T_bc.sum(axis=0)                  # [c,f]
    T_full = T_a.sum(axis=0)                # [f]
    D_bc = jnp.einsum("abbf->abf", T)       # T[a,b,b,f]
    D_ac = jnp.einsum("abaf->abf", T)       # T[a,b,a,f]
    D_aab = jnp.einsum("aacf->acf", T)      # T[a,a,c,f]
    Dg_bc_a = D_bc.sum(axis=1)              # [a,f]
    Dg_ac_b = D_ac.sum(axis=0)              # [b,f]
    Dg_aab_c = D_aab.sum(axis=0)            # [c,f]
    s_aab = Dg_aab_c.sum(axis=0)            # [f]
    s_aba = Dg_ac_b.sum(axis=0)
    s_abb = Dg_bc_a.sum(axis=0)
    t_diag3 = jnp.einsum("aaaf->af", T).sum(axis=0)
    return dict(S=S, R=R, Rc=Rc, trA=trA, diagA=diagA, T_ab=T_ab, T_ac=T_ac,
                T_bc=T_bc, T_a=T_a, T_b=T_b, T_c=T_c, T_full=T_full,
                D_bc=D_bc, D_ac=D_ac, D_aab=D_aab, Dg_bc_a=Dg_bc_a,
                Dg_ac_b=Dg_ac_b, Dg_aab_c=Dg_aab_c, s_aab=s_aab,
                s_aba=s_aba, s_abb=s_abb, t_diag3=t_diag3)


def _cases_1_to_10(q, A, ein, cast, outer):
    return [
        q["T_ab"] * q["S"],                                   # 1 (a,b)
        q["T_ac"] * q["S"],                                   # 2 (a,c)
        outer(q["T_a"], q["R"]),                              # 3 (a,d)
        outer(q["T_a"], q["Rc"]),                             # 4 (a,e)
        q["T_bc"] * q["S"],                                   # 5 (b,c)
        outer(q["T_b"], q["R"]),                              # 6 (b,d)
        outer(q["T_b"], q["Rc"]),                             # 7 (b,e)
        outer(q["T_c"], q["R"]),                              # 8 (c,d)
        outer(q["T_c"], q["Rc"]),                             # 9 (c,e)
        A[:, :, None] * q["T_full"][None, None, :],           # 10 (d,e)
    ]


def risi_contraction_10(T, A):
    """``RisiContraction_10.h:94-228``: the 10 "fix 2, contract 3" cases,
    via shared reductions (no positivity guard in the reference —
    plain multiplication by A).  Matches :func:`risi_contraction_10_spec`.
    """
    acc_t = jnp.promote_types(T.dtype, jnp.float32)
    ein = functools.partial(jnp.einsum, preferred_element_type=acc_t)
    cast = lambda x: x.astype(T.dtype)

    def outer(u, v):
        return u[:, None, :] * v[None, :, None]

    q = _shared_reductions(T, A)
    return jnp.concatenate(_cases_1_to_10(q, A, ein, cast, outer), axis=-1)


def risi_contraction_50(T, A):
    """``RisiContraction_50.h:94-431``: all 50 cases in reference order,
    via shared reductions (cases 1-10: fix-2/contract-3; 11-40: one tied
    pair among the rest; 41-50: all three tied).  Matches
    :func:`risi_contraction_50_spec` (the generic einsum engine), which
    remains the executable specification for the parity tests.
    """
    acc_t = jnp.promote_types(T.dtype, jnp.float32)
    ein = functools.partial(jnp.einsum, preferred_element_type=acc_t)
    cast = lambda x: x.astype(T.dtype)

    def outer(u, v):
        return u[:, None, :] * v[None, :, None]

    q = _shared_reductions(T, A)
    A3 = A[:, :, None]
    T_ab, T_ac, T_bc = q["T_ab"], q["T_ac"], q["T_bc"]
    R, Rc, diagA = q["R"], q["Rc"], q["diagA"]
    ys = _cases_1_to_10(q, A, ein, cast, outer)
    ys += [
        cast(ein("abcf,c->abf", T, R)),                       # 11 (a,b) c=d
        cast(ein("abcf,c->abf", T, Rc)),                      # 12 (a,b) c=e
        T_ab * q["trA"],                                      # 13 (a,b) d=e
        cast(ein("abcf,b->acf", T, R)),                       # 14 (a,c) b=d
        cast(ein("abcf,b->acf", T, Rc)),                      # 15 (a,c) b=e
        T_ac * q["trA"],                                      # 16 (a,c) d=e
        outer(q["Dg_bc_a"], R),                               # 17 (a,d) b=c
        cast(ein("abf,db->adf", T_ab, A)),                    # 18 (a,d) b=e
        cast(ein("acf,dc->adf", T_ac, A)),                    # 19 (a,d) c=e
        outer(q["Dg_bc_a"], Rc),                              # 20 (a,e) b=c
        cast(ein("abf,be->aef", T_ab, A)),                    # 21 (a,e) b=d
        cast(ein("acf,ce->aef", T_ac, A)),                    # 22 (a,e) c=d
        cast(ein("abcf,a->bcf", T, R)),                       # 23 (b,c) a=d
        cast(ein("abcf,a->bcf", T, Rc)),                      # 24 (b,c) a=e
        T_bc * q["trA"],                                      # 25 (b,c) d=e
        outer(q["Dg_ac_b"], R),                               # 26 (b,d) a=c
        cast(ein("abf,da->bdf", T_ab, A)),                    # 27 (b,d) a=e
        cast(ein("bcf,dc->bdf", T_bc, A)),                    # 28 (b,d) c=e
        outer(q["Dg_ac_b"], Rc),                              # 29 (b,e) a=c
        cast(ein("abf,ae->bef", T_ab, A)),                    # 30 (b,e) a=d
        cast(ein("bcf,ce->bef", T_bc, A)),                    # 31 (b,e) c=d
        outer(q["Dg_aab_c"], R),                              # 32 (c,d) a=b
        cast(ein("acf,da->cdf", T_ac, A)),                    # 33 (c,d) a=e
        cast(ein("bcf,db->cdf", T_bc, A)),                    # 34 (c,d) b=e
        outer(q["Dg_aab_c"], Rc),                             # 35 (c,e) a=b
        cast(ein("acf,ae->cef", T_ac, A)),                    # 36 (c,e) a=d
        cast(ein("bcf,be->cef", T_bc, A)),                    # 37 (c,e) b=d
        A3 * q["s_aab"][None, None, :],                       # 38 (d,e) a=b
        A3 * q["s_aba"][None, None, :],                       # 39 (d,e) a=c
        A3 * q["s_abb"][None, None, :],                       # 40 (d,e) b=c
        cast(ein("abcf,c->abf", T, diagA)),                   # 41 (a,b) c=d=e
        cast(ein("abcf,b->acf", T, diagA)),                   # 42 (a,c) b=d=e
        cast(ein("abf,db->adf", q["D_bc"], A)),               # 43 (a,d) b=c=e
        cast(ein("abf,be->aef", q["D_bc"], A)),               # 44 (a,e) b=c=d
        cast(ein("abcf,a->bcf", T, diagA)),                   # 45 (b,c) a=d=e
        cast(ein("abf,da->bdf", q["D_ac"], A)),               # 46 (b,d) a=c=e
        cast(ein("abf,ae->bef", q["D_ac"], A)),               # 47 (b,e) a=c=d
        cast(ein("acf,da->cdf", q["D_aab"], A)),              # 48 (c,d) a=b=e
        cast(ein("acf,ae->cef", q["D_aab"], A)),              # 49 (c,e) a=b=d
        A3 * q["t_diag3"][None, None, :],                     # 50 (d,e) a=b=c
    ]
    return jnp.concatenate(ys, axis=-1)


def risi_contraction_18_spec(T, A):
    """Executable specification of the 18-case bank via the generic engine.

    Applies the reference's ``adj_value > 0`` guard (RisiContraction_18.h:90).
    Used as ground truth by the parity tests; prefer
    :func:`risi_contraction_18` in models.
    """
    Ap = jnp.where(A > 0, A, jnp.zeros_like(A))
    return _contract_cases(T, Ap, _SUBSET_18)


def risi_contraction_18(T, A):
    """Optimized 18-case contraction bank via shared reductions.

    T: [N, N, N, C] stacked neighbor tensors (axis 0 = stacking axis "a"),
    A: [N, N] reduced adjacency.  Returns [N, N, 18*C] with depth layout
    case*C + f, matching ``RisiContraction_18.h`` / ``Tensor3D.h:37``.

    Decomposition: with Ap = A * (A > 0),
      S = sum Ap, R[d] = sum_e Ap[d,e], trA = tr Ap,
      and the T-reductions below, every case is a (broadcast) outer product
      or a single small matmul — O(N^3 C) total work.
    """
    Ap = jnp.where(A > 0, A, jnp.zeros_like(A))
    S = Ap.sum()
    R = Ap.sum(axis=1)                       # [N]
    trA = jnp.trace(Ap)
    # f32 (or wider) accumulation: bf16 states take the bf16 x bf16 -> f32
    # tensor-core path, and f32/f64 are unchanged.
    acc_t = jnp.promote_types(T.dtype, jnp.float32)
    ein = functools.partial(jnp.einsum, preferred_element_type=acc_t)
    cast = lambda x: x.astype(T.dtype)

    T_ab = T.sum(axis=2)                     # [a,b,f] = sum_c
    T_bc = T.sum(axis=0)                     # [b,c,f] = sum_a
    T_a = T_ab.sum(axis=1)                   # [a,f]
    T_b = T_bc.sum(axis=1)                   # [b,f]
    T_full = T_a.sum(axis=0)                 # [f]
    D_bc = jnp.einsum("abbf->abf", T)        # T[a,b,b,f]
    D_ac = jnp.einsum("abaf->abf", T)        # T[a,b,a,f] (kept as [a,b,f])
    D_aab = jnp.einsum("aacf->acf", T)       # T[a,a,c,f] (as [a,c,f])
    s14 = D_aab.sum(axis=(0))                # [c,f] -> sum_a; then sum over c below
    s14 = s14.sum(axis=0)                    # sum_{a,c} T[a,a,c,f]
    s15 = D_bc.sum(axis=(0, 1))              # sum_{a,b} T[a,b,b,f]
    t18 = jnp.einsum("aaaf->af", T).sum(axis=0)
    W16 = jnp.einsum("aeef->aef", T)         # T[a,e,e,f]
    W17 = jnp.einsum("ebef->bef", T)         # T[e,b,e,f]
    Tdiag_ac_b = D_ac.sum(axis=0)            # sum_a T[a,b,a,f] -> [b,f]
    Tdiag_bc_a = D_bc.sum(axis=1)            # sum_b T[a,b,b,f] -> [a,f]

    def outer_vR(u):                         # u: [N, f] -> u[x,f]*R[y]
        return u[:, None, :] * R[None, :, None]

    AoT = Ap[:, :, None]

    y1 = T_ab * S                                         # (a,b) c,d,e
    y2 = outer_vR(T_a)                                    # (a,d) b,c,e
    y3 = T_bc * S                                         # (b,c) a,d,e
    y4 = outer_vR(T_b)                                    # (b,d) a,c,e
    y5 = AoT * T_full[None, None, :]                      # (d,e) a,b,c
    y6 = cast(ein("abdf,d->abf", T, R))                   # (a,b) c==d | e
    y7 = T_ab * trA                                       # (a,b) d==e | c
    y8 = outer_vR(Tdiag_bc_a)                             # (a,d) b==c | e
    y9 = cast(ein("aef,de->adf", T_ab, Ap))               # (a,d) b==e | c
    y10 = cast(ein("dbcf,d->bcf", T, R))                  # (b,c) a==d | e
    y11 = outer_vR(Tdiag_ac_b)                            # (b,d) a==c | e
    y12 = cast(ein("ebf,de->bdf", T_ab, Ap))              # (b,d) a==e | c
    y13 = cast(ein("bef,de->bdf", T_bc, Ap))              # (b,d) c==e | a
    y14 = AoT * s14[None, None, :]                        # (d,e) a==b | c
    y15 = AoT * s15[None, None, :]                        # (d,e) b==c | a
    y16 = cast(ein("aef,de->adf", W16, Ap))               # (a,d) b==c==e
    y17 = cast(ein("bef,de->bdf", W17, Ap))               # (b,d) a==c==e
    y18 = AoT * t18[None, None, :]                        # (d,e) a==b==c

    return jnp.concatenate(
        [y1, y2, y3, y4, y5, y6, y7, y8, y9, y10, y11, y12, y13, y14,
         y15, y16, y17, y18], axis=-1)


def risi_contraction_18_batched(T, A):
    """Batched bank: T [B, N, N, N, C], A [B, N, N] -> [B, N, N, 18C]."""
    return jax.vmap(risi_contraction_18)(T, A)


def _k_blocks(K, C, cases):
    """Slice the channel-reducer K [nCases*C, Cout] into per-case blocks
    (1-based case numbers in the bank's own ordering)."""
    return {c: K[(i) * C:(i + 1) * C] for i, c in enumerate(cases)}


def risi_contraction_10_matmul(T, A, K):
    """Fused 10-case bank + channel matmul (same K-commuting trick as
    :func:`risi_contraction_50_matmul`; ``RisiContraction_10.h:94-228``).
    T: [V, N, N, N, C]; A: [V, N, N]; K: [10C, Cout] -> [V, N, N, Cout].
    """
    C, Cout = T.shape[4], K.shape[1]
    acc_t = jnp.promote_types(T.dtype, jnp.float32)
    ein = functools.partial(jnp.einsum, preferred_element_type=acc_t)
    Kb = _k_blocks(K.astype(acc_t), C, range(1, 11))

    S = A.sum(axis=(1, 2))
    R = A.sum(axis=2)
    Rc = A.sum(axis=1)
    T_ab = T.sum(axis=3)
    T_ac = T.sum(axis=2)
    T_bc = T.sum(axis=1)
    T_a = T_ab.sum(axis=2)
    T_b = T_ab.sum(axis=1)
    T_c = T_bc.sum(axis=1)
    T_full = T_a.sum(axis=1)

    def scal(slab, kb):
        return ein("vxyf,v,fo->vxyo", slab, S, kb)

    Z = scal(T_ab, Kb[1]) + scal(T_ac, Kb[2]) + scal(T_bc, Kb[5])
    U = jnp.concatenate([T_a, T_b, T_c], axis=2)         # [V, N, 3C]
    KR = jnp.concatenate([Kb[k] for k in (3, 6, 8)], axis=0)
    KRc = jnp.concatenate([Kb[k] for k in (4, 7, 9)], axis=0)
    Z += ein("vxo,vy->vxyo", ein("vxf,fo->vxo", U, KR), R)
    Z += ein("vxo,vy->vxyo", ein("vxf,fo->vxo", U, KRc), Rc)
    Z += ein("vxy,vo->vxyo", A, ein("vf,fo->vo", T_full, Kb[10]))
    return Z.astype(T.dtype)


def risi_contraction_50_matmul(T, A, K):
    """Fused 50-case bank + channel matmul: returns Z [V, N, N, Cout]
    == ``vmap(risi_contraction_50)(T, A).reshape(.., 50C) @ K`` without
    ever materializing the [V, N, N, 50C] concat (419 MB at production
    shapes — the dominant cost of the unfused ver7 level step).

    Trick: K acts on the channel axis only, so it commutes through every
    case's spatial structure; each case's K-block is applied to that
    case's SHARED REDUCTION (a [.., C] quantity), and the 50 projected
    slabs sum directly into Z.  Cases group into five shapes:
      * fixed-(x,y) slab * scalar      (S / trA weights fold into K)
      * weighted c/b/a-sums of T       (weights R / Rc / diagA stack)
      * outer products u[x] (x) v[y]   (v in {R, Rc}; u's concat @ K)
      * one-axis matmuls with A        (4 orientation groups share one
                                        contraction each)
      * A[x,y] (x) vector              (vectors project, then broadcast)
    Reference semantics: ``RisiContraction_50.h:94-431`` (no positivity
    guard).  T: [V, N, N, N, C]; A: [V, N, N]; K: [50C, Cout].
    """
    V, N = T.shape[0], T.shape[1]
    C, Cout = T.shape[4], K.shape[1]
    acc_t = jnp.promote_types(T.dtype, jnp.float32)
    ein = functools.partial(jnp.einsum, preferred_element_type=acc_t)
    Kb = _k_blocks(K.astype(acc_t), C, range(1, 51))

    # per-batch A reductions
    S = A.sum(axis=(1, 2))                          # [V]
    R = A.sum(axis=2)                               # [V, N]
    Rc = A.sum(axis=1)                              # [V, N]
    trA = jnp.trace(A, axis1=1, axis2=2)            # [V]
    diagA = jnp.diagonal(A, axis1=1, axis2=2)       # [V, N]

    # T slabs (shared reductions)
    T_ab = T.sum(axis=3)                            # [V,a,b,f]
    T_ac = T.sum(axis=2)
    T_bc = T.sum(axis=1)
    D_bc = jnp.einsum("vabbf->vabf", T)
    D_ac = jnp.einsum("vabaf->vabf", T)
    D_aab = jnp.einsum("vaacf->vacf", T)
    T_a = T_ab.sum(axis=2)                          # [V,a,f]
    T_b = T_ab.sum(axis=1)
    T_c = T_bc.sum(axis=1)
    T_full = T_a.sum(axis=1)                        # [V,f]
    Dg_bc_a = D_bc.sum(axis=2)
    Dg_ac_b = D_ac.sum(axis=1)
    Dg_aab_c = D_aab.sum(axis=1)
    s_aab = Dg_aab_c.sum(axis=1)
    s_aba = Dg_ac_b.sum(axis=1)
    s_abb = Dg_bc_a.sum(axis=1)
    t_diag3 = jnp.einsum("vaaaf->vaf", T).sum(axis=1)

    # ---- scalar-weighted slabs: K folds with the per-batch scalar -------
    def scal(slab, *terms):
        # terms: (scalar [V], K-block); one projection per slab
        Kmix = sum(s[:, None, None] * kb[None] for s, kb in terms)
        return ein("vxyf,vfo->vxyo", slab, Kmix)

    Z = scal(T_ab, (S, Kb[1]), (trA, Kb[13]))
    Z += scal(T_ac, (S, Kb[2]), (trA, Kb[16]))
    Z += scal(T_bc, (S, Kb[5]), (trA, Kb[25]))

    # ---- weighted index-sums of T (weights R/Rc/diagA; 3 per family) ----
    W3 = jnp.stack([R, Rc, diagA], axis=1)          # [V, 3, N]
    for sub, ks in (("vabcf,vwc->vwabf", (11, 12, 41)),
                    ("vabcf,vwb->vwacf", (14, 15, 42)),
                    ("vabcf,vwa->vwbcf", (23, 24, 45))):
        E = ein(sub, T, W3)                         # [V, 3, N, N, C]
        K3 = jnp.stack([Kb[k] for k in ks])         # [3, C, Cout]
        Z += ein("vwxyf,wfo->vxyo", E, K3)

    # ---- outer products u[x] (x) v[y], v in {R, Rc} ---------------------
    U = jnp.concatenate([T_a, T_b, T_c, Dg_bc_a, Dg_ac_b, Dg_aab_c],
                        axis=2)                     # [V, N, 6C]
    KR = jnp.concatenate([Kb[k] for k in (3, 6, 8, 17, 26, 32)], axis=0)
    KRc = jnp.concatenate([Kb[k] for k in (4, 7, 9, 20, 29, 35)], axis=0)
    Z += ein("vxo,vy->vxyo", ein("vxf,fo->vxo", U, KR), R)
    Z += ein("vxo,vy->vxyo", ein("vxf,fo->vxo", U, KRc), Rc)

    # ---- one-axis matmuls with A: 4 orientation groups ------------------
    SLABS = jnp.concatenate([T_ab, T_ac, T_bc, D_bc, D_ac, D_aab], axis=3)
    #                                                  [V, N, N, 6C]

    def kcat(pairs):
        # pairs: (slab index 0..5, case) -> [6C, Cout] with zeros elsewhere
        out = jnp.zeros((6 * C, Cout), acc_t)
        for si, case in pairs:
            out = out.at[si * C:(si + 1) * C].set(Kb[case])
        return out

    # G1: sum_m M[x, m] A[y, m]
    M = ein("vxmf,fo->vxmo", SLABS,
            kcat(((0, 18), (1, 19), (2, 28), (3, 43))))
    Z += ein("vxmo,vym->vxyo", M, A)
    # G2: sum_m M[m, x] A[y, m]
    M = ein("vmxf,fo->vmxo", SLABS,
            kcat(((0, 27), (1, 33), (2, 34), (4, 46), (5, 48))))
    Z += ein("vmxo,vym->vxyo", M, A)
    # G3: sum_m M[x, m] A[m, y]
    M = ein("vxmf,fo->vxmo", SLABS,
            kcat(((0, 21), (1, 22), (2, 31), (3, 44))))
    Z += ein("vxmo,vmy->vxyo", M, A)
    # G4: sum_m M[m, x] A[m, y]
    M = ein("vmxf,fo->vmxo", SLABS,
            kcat(((0, 30), (1, 36), (2, 37), (4, 47), (5, 49))))
    Z += ein("vmxo,vmy->vxyo", M, A)

    # ---- A[x,y] (x) projected vectors -----------------------------------
    vecs = jnp.concatenate([T_full, s_aab, s_aba, s_abb, t_diag3], axis=1)
    Kv = jnp.concatenate([Kb[k] for k in (10, 38, 39, 40, 50)], axis=0)
    Z += ein("vxy,vo->vxyo", A, ein("vf,fo->vo", vecs, Kv))
    return Z.astype(T.dtype)


def risi_contraction_18_dropout(T, A, case_mask):
    """``RisiContraction_18_dropout.h``: case-level dropout.

    ``case_mask`` is an [18] multiplier: at train time a random 0/1 mask
    keeping ``nKept`` cases (draw with :func:`dropout_case_mask`); at eval a
    constant nKept/18 (reference line ~469).
    """
    y = risi_contraction_18(T, A)
    C = T.shape[-1]
    scale = jnp.repeat(case_mask, C)
    return y * scale[None, None, :]


def dropout_case_mask(key, nKept: int, train: bool,
                      n_cases: int = nContractions_18):
    """Draw the per-case mask used by :func:`risi_contraction_18_dropout`."""
    if not train:
        return jnp.full((n_cases,), nKept / n_cases)
    idx = jax.random.permutation(key, n_cases)[:nKept]
    return jnp.zeros((n_cases,)).at[idx].set(1.0)
