"""A/B harness for ELLPACK SpMM formulations.

The workload is BENCH's north-star shape: V=8192, D=16, H=64, random
neighbor ids — out[v] = sum_d w[v,d] * h[nbr[v,d]].  Roofline: ~36.5 MB
of HBM traffic (33.5 MB random 256 B row reads + 2 MB out + 1 MB ids/w)
at ~819 GB/s = ~45 us = ~2.9 Gedges/s.  The r3 recorded number is
472 Medges/s (~277 us), i.e. ~16% of roofline.

Candidate formulations measured here (all bit-compatible with coo_spmm
up to documented accumulation order):

  slotloop      current production path (D takes, f32 FMA chain)
  slotloop_pib  same but sentinel-free indices + promise_in_bounds gather
                (no [h;0] concat, no per-index clamp)
  flat          ONE flat take of [V*D] rows + einsum reduction
  flat_pib      flat with promise_in_bounds
  scan_d        lax.scan over D (one gather+FMA per step, no unroll)
  bf16          slotloop_pib with h in bf16 (halves gathered bytes)
  sorted_seg    host-sorted-by-src flat gather (indices_are_sorted=True)
                + dst scatter via .at[].add

Usage: python tools/bench_spmm.py [V] [D] [H]
"""

import functools
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def chain_time(make_chain, args, chain_len=65, reps=5):
    r1, rk = make_chain(1), make_chain(chain_len)
    float(r1(*args)); float(rk(*args))

    def best(f):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            float(f(*args))
            ts.append(time.perf_counter() - t0)
        return min(ts)

    t1, tk = best(r1), best(rk)
    return max((tk - t1) / (chain_len - 1), 1e-9)


def timed(spmm_fn, nbr, w, h, chain_len=65):
    def chain(k):
        @jax.jit
        def run(nbr, w, h):
            def body(hh, _):
                out = spmm_fn(nbr, w, hh)
                return out.astype(hh.dtype), out.astype(jnp.float32).mean()
            _, zs = jax.lax.scan(body, h, None, length=k)
            return zs.sum()
        return run
    return chain_time(chain, (nbr, w, h), chain_len)


# ---------------------------------------------------------------------
# formulations (sentinel-free variants assume all ids valid, pad w=0)
# ---------------------------------------------------------------------

def spmm_slotloop(nbr, w, h):
    from graphflow_tpu.ops.sparse import ell_spmm
    return ell_spmm(nbr, w, h)


def spmm_slotloop_pib(nbr, w, h):
    V, H = h.shape
    D = nbr.shape[1]
    acc = jnp.zeros((V, H), jnp.float32)
    for d in range(D):
        g = h.at[nbr[:, d]].get(mode="promise_in_bounds")
        acc = acc + w[:, d:d + 1] * g.astype(jnp.float32)
    return acc


def spmm_flat(nbr, w, h):
    V, H = h.shape
    D = nbr.shape[1]
    g = jnp.take(h, nbr.reshape(-1), axis=0).reshape(V, D, H)
    return jnp.einsum("vd,vdh->vh", w, g.astype(jnp.float32),
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)


def spmm_flat_pib(nbr, w, h):
    V, H = h.shape
    D = nbr.shape[1]
    g = h.at[nbr.reshape(-1)].get(mode="promise_in_bounds").reshape(V, D, H)
    return jnp.einsum("vd,vdh->vh", w, g.astype(jnp.float32),
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)


def spmm_scan_d(nbr, w, h):
    V, H = h.shape

    def body(acc, sl):
        ids, wd = sl
        g = h.at[ids].get(mode="promise_in_bounds")
        return acc + wd[:, None] * g.astype(jnp.float32), None

    acc, _ = jax.lax.scan(body, jnp.zeros((V, H), jnp.float32),
                          (nbr.T, w.T))
    return acc


def spmm_sorted_seg(order_src, dst_sorted, w_sorted, h):
    # order_src: [V*D] src ids sorted ascending; dst_sorted aligned
    g = h.at[order_src].get(mode="promise_in_bounds",
                            indices_are_sorted=True)
    contrib = w_sorted[:, None] * g.astype(jnp.float32)
    return jnp.zeros((h.shape[0], h.shape[1]), jnp.float32
                     ).at[dst_sorted].add(contrib)


def main():
    V = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
    D = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    H = int(sys.argv[3]) if len(sys.argv) > 3 else 64

    rng = np.random.RandomState(0)
    nbr = jnp.asarray(rng.randint(0, V, size=(V, D)), jnp.int32)
    w = jnp.asarray(rng.rand(V, D), jnp.float32)
    h = jnp.asarray(rng.randn(V, H), jnp.float32)
    n_edges = V * D

    # reference output for parity
    ref = np.zeros((V, H), np.float64)
    nb, wn = np.asarray(nbr), np.asarray(w)
    hn = np.asarray(h, np.float64)
    for d in range(D):
        ref += wn[:, d:d + 1] * hn[nb[:, d]]

    def report(name, fn, args, out_fn=None):
        try:
            out = np.asarray(jax.jit(fn)(*args), np.float64)
            if out_fn is not None:
                out = out_fn(out)
            err = np.abs(out - ref).max() / (np.abs(ref).max() + 1e-30)
            secs = timed(fn, *args) if len(args) == 3 else \
                chain_time(lambda k: _chain_generic(fn, args, k), args)
            print(f"{name:16s} {secs*1e6:9.1f} us  "
                  f"{n_edges/secs/1e6:9.1f} Medges/s  relerr {err:.2e}")
        except Exception as e:
            print(f"{name:16s} FAILED {type(e).__name__}: {e}")

    def _chain_generic(fn, args, k):
        @jax.jit
        def run(*a):
            def body(c, _):
                out = fn(*a[:-1], c)
                return out.astype(a[-1].dtype), out.astype(jnp.float32).mean()
            _, zs = jax.lax.scan(body, a[-1], None, length=k)
            return zs.sum()
        return run

    report("slotloop", spmm_slotloop, (nbr, w, h))
    report("slotloop_pib", spmm_slotloop_pib, (nbr, w, h))
    report("flat", spmm_flat, (nbr, w, h))
    report("flat_pib", spmm_flat_pib, (nbr, w, h))
    report("scan_d", spmm_scan_d, (nbr, w, h))

    # bf16 h (and bf16 gather) — halves the random-read bytes
    h16 = h.astype(jnp.bfloat16)
    out16 = np.asarray(jax.jit(spmm_slotloop_pib)(nbr, w, h16), np.float64)
    err16 = np.abs(out16 - ref).max() / np.abs(ref).max()
    secs16 = timed(spmm_slotloop_pib, nbr, w, h16)
    print(f"{'bf16_slot_pib':16s} {secs16*1e6:9.1f} us  "
          f"{n_edges/secs16/1e6:9.1f} Medges/s  relerr {err16:.2e}")

    # sorted-by-src gather + scatter-add
    flat_src = np.asarray(nbr).reshape(-1)
    order = np.argsort(flat_src, kind="stable")
    src_s = jnp.asarray(flat_src[order], jnp.int32)
    dst_s = jnp.asarray((np.arange(V * D) // D)[order], jnp.int32)
    w_s = jnp.asarray(np.asarray(w).reshape(-1)[order], jnp.float32)

    def sorted_fn(src, dst, wt, hh):
        return spmm_sorted_seg(src, dst, wt, hh)

    try:
        out = np.asarray(jax.jit(sorted_fn)(src_s, dst_s, w_s, h), np.float64)
        err = np.abs(out - ref).max() / np.abs(ref).max()
        secs = chain_time(lambda k: _chain_generic(sorted_fn,
                                                   (src_s, dst_s, w_s, h), k),
                          (src_s, dst_s, w_s, h))
        print(f"{'sorted_seg':16s} {secs*1e6:9.1f} us  "
              f"{n_edges/secs/1e6:9.1f} Medges/s  relerr {err:.2e}")
    except Exception as e:
        print(f"{'sorted_seg':16s} FAILED {type(e).__name__}: {e}")


if __name__ == "__main__":
    main()
