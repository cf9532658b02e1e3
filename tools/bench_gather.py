"""A/B of neighbor-gather formulations inside one SMP_omega level.

The level's first step builds T[v, i, p1, p2] = f_{w_i}[pos[v,i,p1],
pos[v,i,p2]] (smp2d._gather_neighbor_tensors).  Three ways to build it:

  flat    one row gather over the flat [(V+1)(P+1)(P+1), C] view (the
          model's form)
  take    a row gather over [(V+1)(P+1), (P+1)C] for p1, then the p2 side
          as a one-hot einsum at HIGHEST precision
  onehot  the neighbor gather and both alignments as one-hot einsums at
          HIGHEST precision

Each form's T is checked bit-for-bit against the flat gather, then the
whole level (gather + 18-case bank + K + bias + LeakyReLU) is timed with
each form, forward and forward+backward, f32 and bf16: warm medians of
calls that end in block_until_ready (bench.py's method).

Usage: python tools/bench_gather.py [V] [P] [C]
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bench import level_fns, level_inputs, warm_median  # noqa: E402
from graphflow_tpu.models import smp2d  # noqa: E402

_ein = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


def gather_take(state_pad, nbr, pos):
    V, Q, C = state_pad.shape[0], state_pad.shape[1], state_pad.shape[3]
    Vout, P = nbr.shape
    dt = state_pad.dtype
    src = jnp.concatenate([state_pad.reshape(V * Q, Q * C),
                           jnp.zeros((Q, Q * C), dt)], axis=0)
    rows = nbr[:, :, None] * Q + pos
    Ar = jnp.take(src, rows.reshape(-1), axis=0).reshape(Vout, P, P, Q, C)
    Xsel = (pos[..., None] == jnp.arange(Q)).astype(dt)
    return _ein("vabqc,vapq->vabpc", Ar, Xsel).astype(dt)


def gather_onehot(state_pad, nbr, pos):
    V, Q = state_pad.shape[0], state_pad.shape[1]
    dt = state_pad.dtype
    onehot = (nbr[..., None] == jnp.arange(V)).astype(dt)         # [V,P,V]
    Fn = _ein("vim,mqrc->viqrc", onehot, state_pad).astype(dt)
    Xsel = (pos[..., None] == jnp.arange(Q)).astype(dt)          # [V,P,P,Q]
    T = _ein("vipq,viqrc->viprc", Xsel, Fn).astype(dt)
    return _ein("visr,viprc->vipsc", Xsel, T).astype(dt)


FORMS = {"flat": smp2d._gather_neighbor_tensors,
         "take": gather_take,
         "onehot": gather_onehot}


def main():
    V = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    P = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    C = int(sys.argv[3]) if len(sys.argv) > 3 else 32
    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind}", flush=True)

    production = smp2d._gather_neighbor_tensors
    try:
        for dtype in ("float32", "bfloat16"):
            args = level_inputs(V, P, C, dtype)
            state_pad = jnp.pad(args[0], ((0, 0), (0, 1), (0, 1), (0, 0)))
            want = np.asarray(jax.jit(production)(state_pad, *args[1:3]))
            for name, form in FORMS.items():
                got = np.asarray(jax.jit(form)(state_pad, *args[1:3]))
                exact = bool(np.array_equal(got.view(np.uint8),
                                            want.view(np.uint8)))
                smp2d._gather_neighbor_tensors = form
                fwd, train = level_fns(V, P, C)
                t_fwd = warm_median(fwd, *args)
                t_train = warm_median(train, *args)
                smp2d._gather_neighbor_tensors = production
                print(f"{name:7s} {dtype:9s} bit-exact={exact}  "
                      f"level fwd {t_fwd * 1e3:.4f} ms  "
                      f"fwd+bwd {t_train * 1e3:.4f} ms", flush=True)
    finally:
        smp2d._gather_neighbor_tensors = production


if __name__ == "__main__":
    main()
