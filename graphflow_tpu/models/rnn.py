"""Sequence models: LSTM and GRU for per-timestep classification.

Reference: ``LSTM.h`` / ``GRU.h`` — per-timestep unrolled cells with a
cumulative-average-pooled softmax head at EVERY step (``LSTM.h:337-345``:
pool_l = mean(h_0..h_l), logits_l = theta @ pool_l, LogLoss per step),
per-tensor L1 gradient clipping at 1.0 (``LSTM.h:72-78``), Momentum, and a
keep-best backtracking Learn loop (``LSTM.h:97-144``).

Design: the unrolled per-level graph becomes one ``lax.scan``; the whole
(sequence, targets) pair trains in a single jitted program.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from graphflow_tpu import optim as optim_lib
from graphflow_tpu.optim.utils import uniform_init
from graphflow_tpu.utils import checkpoint as ckpt

GRADIENT_CLIPPING_THRESHOLD = 1.0  # LSTM.h:27


def clip_gradients_l1(grads, threshold=GRADIENT_CLIPPING_THRESHOLD):
    """Per-tensor L1-norm clipping (reference ``gradient_clipping``)."""

    def clip(g):
        n = jnp.sum(jnp.abs(g))
        return jnp.where(n > threshold, threshold / n * g, g)

    return jax.tree_util.tree_map(clip, grads)


def _lstm_cell(params, carry, x):
    h, c = carry
    i = jax.nn.sigmoid(params["Wi"] @ x + params["bi"] + params["Ui"] @ h)
    ct = jnp.tanh(params["Wc"] @ x + params["bc"] + params["Uc"] @ h)
    f = jax.nn.sigmoid(params["Wf"] @ x + params["bf"] + params["Uf"] @ h)
    c_new = i * ct + f * c
    o = jax.nn.sigmoid(params["Wo"] @ x + params["bo"]
                       + params["Vo"] @ c_new + params["Uo"] @ h)
    h_new = o * jnp.tanh(c_new)
    return (h_new, c_new), h_new


def _gru_cell(params, h, x):
    z = jax.nn.sigmoid(params["W_z"] @ x + params["b_z"] + params["U_z"] @ h)
    r = jax.nn.sigmoid(params["W_r"] @ x + params["b_r"] + params["U_r"] @ h)
    # The candidate node is CONSTRUCTED as Tanh (GRU.h:289) but registered
    # under the SIGMOID opcode; GraphFlow's dispatcher C-casts and runs the
    # non-virtual Sigmoid::forward (same layout), so the shipped binary's
    # candidate activation IS the sigmoid — reproduced here and
    # binary-pinned in test_model_parity3 (same quirk family as the
    # SMP_2D_ver2 TENSORMUL cast).
    ht = jax.nn.sigmoid(
        params["W_h"] @ x + params["b_h"] + params["U_h"] @ (r * h))
    h_new = z * ht + (1.0 - z) * h      # GRU.h:292-300 convention
    return h_new, h_new


class _SequenceModel:
    """Shared LSTM/GRU machinery (reference API: Learn / Predict /
    getLoss / save_model / load_model)."""

    def __init__(self, nFeatures, nHiddens, nClasses, max_nLevels,
                 momentum_param=0.9, seed=0):
        self.nFeatures, self.nHiddens = nFeatures, nHiddens
        self.nClasses, self.max_nLevels = nClasses, max_nLevels
        self.opt = optim_lib.momentum(gamma=momentum_param)
        self.params = self._init_params(jax.random.PRNGKey(seed))
        self.opt_state = self.opt.init(self.params)

        def seq_losses(params, xs, targets):
            hs = self._run(params, xs)                     # [T, H]
            T = xs.shape[0]
            pooled = jnp.cumsum(hs, axis=0) / jnp.arange(
                1, T + 1, dtype=hs.dtype)[:, None]          # mean(h_0..h_l)
            logits = pooled @ params["theta"].T             # [T, nClasses]
            # The reference wires LogLoss on top of the SOFTMAX node
            # (LSTM.h: logl = LogLoss(softmax, target); LogLoss.h re-runs a
            # max-subtracted softmax on its input) — the trained objective
            # is a DOUBLE softmax, and the Softmax node backpropagates the
            # reference's diagonal-only Jacobian (activations.softmax).
            # Binary-pinned in test_model_parity3.
            from graphflow_tpu.ops import activations
            probs = activations.softmax(logits, axis=-1)
            logp = jax.nn.log_softmax(probs, axis=-1)
            return -jnp.take_along_axis(
                logp, targets[:, None], axis=1).squeeze(1)  # [T]

        self._seq_losses = jax.jit(seq_losses)
        self._grad = jax.jit(jax.value_and_grad(
            lambda p, xs, t: seq_losses(p, xs, t).sum()))
        self._predict = jax.jit(lambda p, xs: jnp.argmax(
            (jnp.cumsum(self._run(p, xs), axis=0)
             / jnp.arange(1, xs.shape[0] + 1, dtype=xs.dtype)[:, None])
            @ p["theta"].T, axis=-1))

    # -- per-architecture -----------------------------------------------
    def _init_params(self, key):
        raise NotImplementedError

    def _run(self, params, xs):
        raise NotImplementedError

    # -- reference API ---------------------------------------------------
    def getLoss(self, x_sequence, target_sequence) -> float:
        """Total negative log-likelihood of the sequence (the reference's
        ``getLoss`` returns +log p summed; sign folded here)."""
        xs = jnp.asarray(np.asarray(x_sequence, np.float32))
        ts = jnp.asarray(np.asarray(target_sequence, np.int32))
        return float(self._seq_losses(self.params, xs, ts).sum())

    def Learn(self, x_sequence, target_sequence, nIterations,
              learning_rate) -> Tuple[float, float]:
        """Keep-best training loop with LR halving (``LSTM.h:97-144``)."""
        xs = jnp.asarray(np.asarray(x_sequence, np.float32))
        ts = jnp.asarray(np.asarray(target_sequence, np.int32))
        best_nll, _ = self._grad(self.params, xs, ts)
        best_nll = float(best_nll)
        first = best_nll
        lr, min_lr, decay = learning_rate, 1e-20, 0.5
        best = (self.params, self.opt_state)
        for _ in range(nIterations):
            nll, grads = self._grad(self.params, xs, ts)
            grads = clip_gradients_l1(grads)
            self.params, self.opt_state = self.opt.update(
                self.params, self.opt_state, grads, lr)
            new_nll = float(self._grad(self.params, xs, ts)[0])
            if new_nll >= best_nll:       # worse or equal: restore, decay
                self.params, self.opt_state = best
                if lr <= min_lr:
                    break
                lr *= decay
            else:
                best_nll = new_nll
                best = (self.params, self.opt_state)
        return first, best_nll

    def Predict(self, x_sequence):
        xs = jnp.asarray(np.asarray(x_sequence, np.float32))
        return np.asarray(self._predict(self.params, xs))

    def save_model(self, filename):
        ckpt.save_text(filename, self.params, None)

    def load_model(self, filename):
        self.params = ckpt.load_text(filename, self.params, None)
        self.opt_state = self.opt.init(self.params)


class LSTM(_SequenceModel):
    """``LSTM.h:30-41``."""

    def _init_params(self, key):
        F, H, C = self.nFeatures, self.nHiddens, self.nClasses
        names = [("Wi", (H, F)), ("Ui", (H, H)), ("bi", (H,)),
                 ("Wc", (H, F)), ("Uc", (H, H)), ("bc", (H,)),
                 ("Wf", (H, F)), ("Uf", (H, H)), ("bf", (H,)),
                 ("Wo", (H, F)), ("Uo", (H, H)), ("Vo", (H, H)),
                 ("bo", (H,)), ("theta", (C, H))]
        keys = jax.random.split(key, len(names))
        return {n: uniform_init(k, s, jnp.float32)
                for (n, s), k in zip(names, keys)}

    def _run(self, params, xs):
        H = self.nHiddens
        init = (jnp.zeros((H,)), jnp.zeros((H,)))
        _, hs = jax.lax.scan(
            lambda c, x: _lstm_cell(params, c, x), init, xs)
        return hs


class GRU(_SequenceModel):
    """``GRU.h``: same API, GRU cell."""

    def _init_params(self, key):
        F, H, C = self.nFeatures, self.nHiddens, self.nClasses
        names = [("W_z", (H, F)), ("U_z", (H, H)), ("b_z", (H,)),
                 ("W_r", (H, F)), ("U_r", (H, H)), ("b_r", (H,)),
                 ("W_h", (H, F)), ("U_h", (H, H)), ("b_h", (H,)),
                 ("theta", (C, H))]
        keys = jax.random.split(key, len(names))
        return {n: uniform_init(k, s, jnp.float32)
                for (n, s), k in zip(names, keys)}

    def _run(self, params, xs):
        init = jnp.zeros((self.nHiddens,))
        _, hs = jax.lax.scan(
            lambda h, x: _gru_cell(params, h, x), init, xs)
        return hs
