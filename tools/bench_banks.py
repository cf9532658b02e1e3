"""Timing of the contraction-bank family on the GPU.

Measures, at production shapes (V=256 vertex neighborhoods, P=16, C=32):
  * bank-only (from materialized T): 4 / 10 / 18 / 50 cases + K matmul,
    via the shared-reduction XLA banks;
  * the FULL level step (gather + bank + K) for contraction 50 (the
    SMP_2D_ver7 level) vs contraction 18 (the ver8/omega level) and
    contraction 10 (ver6).

The comparison is per case: ms_50 / 50 vs ms_18 / 18.  Times are warm
medians of calls that end in block_until_ready (bench.py's method).

Usage: python tools/bench_banks.py [V] [P] [C]
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bench import warm_median  # noqa: E402


def bank_time(bank_fn, nCon, B, P, C, takes_adj=True):
    rng = np.random.RandomState(0)
    T = jnp.asarray(rng.randn(B, P, P, P, C), jnp.float32)
    A = jnp.abs(jnp.asarray(rng.randn(B, P, P), jnp.float32))
    K = jnp.asarray(rng.randn(nCon * C, C) * 0.1, jnp.float32)

    @jax.jit
    def run(T, A, K):
        Y = jax.vmap(bank_fn)(T, A) if takes_adj else jax.vmap(bank_fn)(T)
        return Y.reshape(B * P * P, nCon * C) @ K

    return warm_median(run, T, A, K)


def level_time(contraction, V, P, C):
    from graphflow_tpu.models.smp2d import SMP2DConfig, smp2d_states

    rng = np.random.RandomState(0)
    cfg = SMP2DConfig(max_nVertices=V, max_receptive_field=P, nLevels=1,
                      nChanels=C, nFeatures=4, nDepth=2,
                      contraction=contraction)
    params = {
        "H": jnp.asarray(rng.randn(C, cfg.feat_dim) * 0.1, jnp.float32),
        "levels": [{
            "K": jnp.asarray(rng.randn(contraction * C, C) * 0.1,
                             jnp.float32),
            "b": jnp.zeros((C,), jnp.float32)}],
        "W": jnp.asarray(rng.randn(C), jnp.float32),
    }
    g = {
        "vmask": jnp.ones((V,), jnp.float32),
        "wl_feat": jnp.asarray(rng.randn(V, cfg.feat_dim), jnp.float32),
        "nbr": jnp.asarray(rng.randint(0, V, size=(1, V, P)), jnp.int32),
        "pos": jnp.asarray(rng.randint(0, P + 1, size=(1, V, P, P)),
                           jnp.int32),
        "radj": jnp.abs(jnp.asarray(rng.randn(1, V, P, P), jnp.float32)),
        "smask": jnp.ones((2, V, P, P), jnp.float32),
    }
    run = jax.jit(lambda params, g: smp2d_states(params, g, cfg)[-1])
    return warm_median(run, params, g)


def main():
    from graphflow_tpu.ops import contractions as ct

    V = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    P = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    C = int(sys.argv[3]) if len(sys.argv) > 3 else 32

    print("bank-only (from materialized T), XLA shared reductions:",
          flush=True)
    for name, fn, nCon, adj in (
            ("risi4", ct.risi_contraction_4, 4, False),
            ("risi10", ct.risi_contraction_10, 10, True),
            ("risi18", ct.risi_contraction_18, 18, True),
            ("risi50", ct.risi_contraction_50, 50, True)):
        secs = bank_time(fn, nCon, V, P, C, takes_adj=adj)
        print(f"  {name:8s} {secs*1e3:8.3f} ms  "
              f"({secs*1e3/nCon:6.4f} ms/case)", flush=True)

    print("full level step (gather + bank + K):", flush=True)
    t18 = level_time(18, V, P, C)
    print(f"  ver8 (18, prod path) {t18*1e3:8.3f} ms "
          f"({t18*1e3/18:6.4f} ms/case)", flush=True)
    t50 = level_time(50, V, P, C)
    print(f"  ver7 (50)           {t50*1e3:8.3f} ms "
          f"({t50*1e3/50:6.4f} ms/case)", flush=True)
    t10 = level_time(10, V, P, C)
    print(f"  ver6 (10)           {t10*1e3:8.3f} ms "
          f"({t10*1e3/10:6.4f} ms/case)", flush=True)
    ratio = (t50 / 50) / (t18 / 18)
    print(f"per-case ratio ver7/ver8: {ratio:.2f}x "
          f"(target: <= 2x)", flush=True)


if __name__ == "__main__":
    main()
