"""GraphFlow-TPU: a JAX deep learning framework for graph neural networks.

A from-scratch JAX/XLA re-design of the capabilities of GraphFlow
(HyTruongSon/GraphFlow): symbolic differentiation over computation graphs,
a ~70-op differentiable op library, the Covariant Compositional Network (CCN)
"Steerable Message Passing" model family with permutation-covariant tensor
contractions (RisiContraction 4/10/18/50), plus GCN, Neural Graph Fingerprint,
PATCHY-SAN, Gated Graph Sequence Networks, MLP/CNN/LSTM/GRU/autoencoders.
The accelerator it runs on is an NVIDIA GPU (H100); tests run on the CPU.

Design (a re-design, not a port):
  * The reference's dynamic per-example computation graphs become trace-once
    JIT-compiled pure functions over padded, masked graph batches.
  * The reference's hand-written forward/backward loops become `jax.grad`.
  * The reference's CPU-thread/CUDA-stream data parallelism becomes
    `shard_map` over a `jax.sharding.Mesh` with `psum` gradient reduction.
  * The reference's two precision trees (double/float) collapse into a dtype
    parameter; bfloat16 is first-class for tensor-core throughput.

Reference layout mapping (see SURVEY.md for the full inventory):
  GraphFlow/{Vector,Matrix,Tensor3D,Tensor4D}.h -> jnp arrays (L0)
  GraphFlow/GraphFlow.h (type-tag engine)       -> XLA itself (L1)
  GraphFlow/*.h op headers                      -> graphflow_tpu.ops (L2/L3)
  GraphFlow/{SGD,Momentum,Adam,...}.h           -> graphflow_tpu.optim (L4)
  GraphFlow/DenseGraph.h                        -> graphflow_tpu.core.graph (L5)
  GraphFlow/SMP_*.h, GCN_*.h, ...               -> graphflow_tpu.models (L6)
  tests/*.cpp                                   -> tests/ (pytest, real asserts)
"""

from graphflow_tpu.version import __version__


def compilation_cache_dir() -> str:
    """The persistent XLA compilation cache's directory:
    ``JAX_COMPILATION_CACHE_DIR`` when set (JAX reads it itself), otherwise
    ``.jax_cache`` at the root of the checkout (listed in ``.gitignore``):
    a fixed path, so a later process finds what an earlier one stored."""
    import os

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".jax_cache")


def _enable_compilation_cache():
    """Keep compiled GPU programs across processes.

    CPU-only processes (tests, the multichip dryrun) skip it: XLA:CPU
    compiles are fast, and reloading AOT entries compiled under different
    host-feature flags spams pages of cpu_aot_loader errors.
    """
    import os

    if os.environ.get("JAX_PLATFORMS", "").strip().lower() == "cpu":
        return
    import jax

    if jax.config.jax_compilation_cache_dir is not None:
        return            # JAX_COMPILATION_CACHE_DIR or the caller's choice
    path = compilation_cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_enable_compilation_cache()

from graphflow_tpu.core.graph import DenseGraph
from graphflow_tpu.core import prep
from graphflow_tpu import ops
from graphflow_tpu import optim
from graphflow_tpu import models

__all__ = [
    "__version__",
    "DenseGraph",
    "prep",
    "ops",
    "optim",
    "models",
]
