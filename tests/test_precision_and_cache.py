"""Exact selection on the GPU, and where the compile cache lives.

On the GPU an f32 matrix product at default precision may run in TF32,
which keeps 10 mantissa bits.  A product whose one operand is a 0/1
selection or adjacency matrix only moves or adds values, so it must not
round them: every such dot_general in the second-order (smp2d), first-order
(smp1d) and steerable neighbor sums is either absent (a gather) or pinned to
HIGHEST.  The CPU backend ignores the setting, hence a check on the jaxpr.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.extend.core import ClosedJaxpr, Jaxpr

import graphflow_tpu
from graphflow_tpu.models import smp1d, smp2d, smp2d_steerable


def _eqns(jaxpr):
    for eqn in jaxpr.eqns:
        yield eqn
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else (v,)):
                if isinstance(sub, ClosedJaxpr):
                    yield from _eqns(sub.jaxpr)
                elif isinstance(sub, Jaxpr):
                    yield from _eqns(sub)


def _dot_precisions(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
    return [e.params["precision"] for e in _eqns(jaxpr)
            if e.primitive.name == "dot_general"]


def _selection_args(V=5, P=3, C=2, rank=1):
    rng = np.random.RandomState(0)
    f = jnp.asarray(rng.randn(V, *([P] * rank), C), jnp.float32)
    vid_prev = jnp.asarray(rng.randint(0, V + 1, (V, P)), jnp.int32)
    vid_cur = jnp.asarray(rng.randint(0, V + 1, (V, P)), jnp.int32)
    adj1 = jnp.asarray(rng.randint(0, 2, (V, V)), jnp.float32)
    return f, vid_prev, adj1, vid_cur


NEIGHBOR_SUMS = {
    "smp2d_gather": (
        smp2d._gather_neighbor_tensors,
        lambda: (jnp.zeros((5, 4, 4, 2), jnp.float32),
                 jnp.zeros((5, 3), jnp.int32),
                 jnp.zeros((5, 3, 3), jnp.int32)),
        0),
    "smp1d_neighbor_sum": (
        lambda f, vp, a, vc: smp1d._neighbor_sum(f, vp, a, vc, 5, 3, 2),
        lambda: _selection_args(rank=1),
        3),
    "steerable_neighbor_quadratic_sum": (
        lambda f, vp, a, vc: smp2d_steerable._neighbor_quadratic_sum(
            f, vp, a, vc, 5, 3, 2, block=1),
        lambda: _selection_args(rank=2),
        5),
}


@pytest.mark.parametrize("name", list(NEIGHBOR_SUMS))
def test_selection_products_are_exact(name):
    fn, make_args, n_dots = NEIGHBOR_SUMS[name]
    precisions = _dot_precisions(fn, *make_args())
    assert len(precisions) == n_dots
    for p in precisions:
        assert p is not None and all(
            q == jax.lax.Precision.HIGHEST for q in p), p


@pytest.mark.parametrize("env,platforms,expected", [
    ("set", "", "env"),
    ("unset", "", "checkout"),
    ("unset", "cpu", None),
], ids=["env-set", "env-unset", "cpu-only"])
def test_compilation_cache_dir(monkeypatch, tmp_path, env, platforms,
                               expected):
    """JAX_COMPILATION_CACHE_DIR when set; otherwise one fixed directory
    inside the checkout that .gitignore lists; CPU-only processes keep
    none."""
    if env == "set":
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setenv("JAX_PLATFORMS", platforms)
    updates = {}

    class FreshConfig:         # jax.config of a process that set no cache
        jax_compilation_cache_dir = None

        @staticmethod
        def update(key, value):
            updates[key] = value

    monkeypatch.setattr(jax, "config", FreshConfig)
    graphflow_tpu._enable_compilation_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        graphflow_tpu.__file__)))
    want = {"env": str(tmp_path), "checkout": os.path.join(root, ".jax_cache"),
            None: None}[expected]
    assert updates.get("jax_compilation_cache_dir") == want
    assert graphflow_tpu.compilation_cache_dir() == (
        want or os.path.join(root, ".jax_cache"))
    if expected == "checkout":
        with open(os.path.join(root, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


def test_trace_split_by_named_scope(tmp_path):
    """The trace reduction charges each op to its jax.named_scope; on the
    CPU backend the ops run on the host plane."""
    from graphflow_tpu.utils.profiling import device_time_by_scope

    @jax.jit
    def f(x):
        with jax.named_scope("bank"):
            y = jnp.sin(x) @ x
        with jax.named_scope("channel_matmul"):
            y = y @ x
        return y.sum()

    x = jnp.ones((128, 128), jnp.float32)
    compiled = f.lower(x).compile(
        compiler_options={"xla_gpu_enable_command_buffer": ""})
    text = compiled.as_text()
    compiled(x).block_until_ready()
    jax.profiler.start_trace(str(tmp_path))
    compiled(x).block_until_ready()
    jax.profiler.stop_trace()
    split = device_time_by_scope(str(tmp_path), [text],
                                 ["bank", "channel_matmul"], "/host:CPU")
    assert split["bank"] > 0 and split["channel_matmul"] > 0
    assert device_time_by_scope(str(tmp_path), [text], ["bank"]) == {
        "bank": 0.0, "other": 0.0}
