"""Profiling and timing utilities (SURVEY.md section 5).

The reference hand-rolls wall-clock timers in each test driver
(``tests/test_SMP_omega.cpp:151-207`` time(), ``test_RisiContraction_18_gpu.cu:31-40``
gettimeofday).  Here timing is a first-class module with JAX-aware semantics:

  * ``Timer`` — wall-clock context manager / accumulator
  * ``time_jax`` — robust accelerator timing (block_until_ready fencing,
    warmup, per-call statistics)
  * ``trace`` — wraps jax.profiler tracing for XLA device timelines
  * ``device_time_by_scope`` — reduces such a trace to device time per
    ``jax.named_scope``
  * ``gpu_card`` — the card's name and power limit from nvidia-smi
"""

from __future__ import annotations

import contextlib
import glob
import os
import re
import subprocess
import time
from typing import Callable, Dict, Sequence

import jax
import numpy as np


class Timer:
    """Accumulating wall-clock timer.

    >>> t = Timer()
    >>> with t:
    ...     work()
    >>> t.total, t.count, t.mean
    """

    def __init__(self):
        self.total = 0.0
        self.count = 0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.total += time.perf_counter() - self._t0
        self.count += 1
        return False

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)


def time_jax(fn: Callable, *args, iters: int = 10, warmup: int = 2,
             **kwargs) -> Dict[str, float]:
    """Time a JAX callable with device fencing.

    Blocks on every call's output (async dispatch returns before the
    device finishes).  Returns {mean, min, max, std} in seconds.
    """
    def run_once():
        out = fn(*args, **kwargs)
        jax.tree_util.tree_map(
            lambda x: x.block_until_ready() if hasattr(x, "block_until_ready")
            else x, out)

    for _ in range(warmup):
        run_once()
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        run_once()
        samples.append(time.perf_counter() - t0)
    a = np.asarray(samples)
    return {"mean": float(a.mean()), "min": float(a.min()),
            "max": float(a.max()), "std": float(a.std())}


@contextlib.contextmanager
def trace(logdir: str):
    """XLA profiler trace context (view with TensorBoard/xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


_HLO_OP_NAME = re.compile(
    r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name="([^"]*)"', re.M)


def _kernel_key(name: str) -> str:
    # GPU kernels are named after their HLO instruction with "." and "-"
    # spelled "_" (fusion.4 -> fusion_4).
    return re.sub(r"[.\-]", "_", name)


def device_time_by_scope(logdir: str, hlo_texts: Sequence[str],
                         scopes: Sequence[str],
                         plane_prefix: str = "/device:") -> Dict[str, float]:
    """Device seconds per named scope in the newest trace under ``logdir``.

    Every kernel event is matched to its HLO instruction (the ``hlo_op``
    stat, or the kernel's own name inside a CUDA-graph command buffer) and
    charged to the first of ``scopes`` found as a path element of that
    instruction's ``op_name`` in ``hlo_texts`` (the compiled modules'
    ``as_text()``; a fusion carries its root's name, and backward ops
    ``transpose(jvp(scope))``), else to "other".  Library kernels inside a
    command buffer cannot be matched, so trace an executable compiled with
    ``xla_gpu_enable_command_buffer=""``.  Only planes named with
    ``plane_prefix`` are read: the CPU backend runs its ops on the host
    ("/host:CPU"), so there the device planes hold nothing.
    """
    from jax.profiler import ProfileData

    op_scope = {}
    for text in hlo_texts:
        for inst, op_name in _HLO_OP_NAME.findall(text):
            parts = re.split(r"[/()]", op_name)
            op_scope[_kernel_key(inst)] = next(
                (sc for sc in scopes if sc in parts), "other")
    paths = sorted(glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    # Kernel events sit on the per-stream lines; "XLA Ops" is a derived
    # line that repeats them, so it is read only when there is no other.
    kernels, derived = [], []
    for plane in ProfileData.from_file(paths[-1]).planes:
        if plane.name.startswith(plane_prefix):
            for line in plane.lines:
                (derived if line.name.startswith("XLA") else kernels).append(
                    [ev for ev in line.events if "hlo_op" in dict(ev.stats)])
    out = {sc: 0.0 for sc in list(scopes) + ["other"]}
    for events in (kernels if any(kernels) else derived):
        for ev in events:
            op = dict(ev.stats)["hlo_op"]
            key = _kernel_key(ev.name if op == "command_buffer" else op)
            out[op_scope.get(key, "other")] += ev.duration_ns * 1e-9
    return out


def gpu_card() -> str:
    """``name, power.limit`` of each card, as nvidia-smi reports them (run
    in a child process that never touches JAX)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def step_timer(step_fn: Callable):
    """Wrap a train step with a Timer; returns (wrapped, timer)."""
    t = Timer()

    def wrapped(*args, **kwargs):
        with t:
            out = step_fn(*args, **kwargs)
            jax.tree_util.tree_map(
                lambda x: x.block_until_ready()
                if hasattr(x, "block_until_ready") else x, out)
        return out

    return wrapped, t
