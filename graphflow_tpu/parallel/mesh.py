"""Device mesh helpers + multi-host scaffolding.

The reference's maximum parallel scope is CPU threads + one GPU with streams
(SURVEY.md section 2.8); this framework scales instead via named meshes and
collectives, which XLA hands to NCCL.  Axis conventions:

  "host"  — the axis across hosts (the network between machines: slow,
            high-latency); only gradient psums should cross it
  "data"  — batch (graph-level) data parallelism; psum of gradients
  "graph" — partitioned-graph parallelism (vertices/edges of the padded
            batch sharded across cards, halo exchange for boundaries);
            keep it inside one host, whose cards NVLink joins all to all

Multi-host: call :func:`init_distributed` once per process, then build a
host x card mesh with :func:`make_hybrid_mesh` — host axes lead (slowest
varying), per-host axes trail, so collectives over the trailing axes stay
inside a host.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(axis_shapes: Optional[dict] = None, devices=None) -> Mesh:
    """Build a mesh from {axis_name: size}. Default: 1-D "data" mesh over
    all local devices."""
    if devices is None:
        devices = jax.devices()
    if axis_shapes is None:
        axis_shapes = {"data": len(devices)}
    names = tuple(axis_shapes.keys())
    shape = tuple(axis_shapes.values())
    n = int(np.prod(shape))
    assert n <= len(devices), f"need {n} devices, have {len(devices)}"
    dev_array = np.asarray(devices[:n]).reshape(shape)
    return Mesh(dev_array, names)


def data_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Shard the leading (batch) axis of every array over ``axis``."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


_DISTRIBUTED_INITIALIZED = False


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     **kwargs) -> int:
    """Initialize the multi-host runtime (wraps ``jax.distributed``).

    The reference is strictly single-process (SURVEY.md section 2.8: no
    MPI/NCCL/Gloo anywhere); this is the scale-out entry point.
    Arguments default to the standard JAX coordinator environment
    variables; on single-process launches (nothing configured) this is a
    no-op.  Returns the process count.  Idempotent.
    """
    global _DISTRIBUTED_INITIALIZED
    if _DISTRIBUTED_INITIALIZED:
        return jax.process_count()
    coordinator_address = (coordinator_address
                           or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if coordinator_address is None and num_processes is None:
        # Single-process launch: jax.distributed not needed.
        _DISTRIBUTED_INITIALIZED = True
        return jax.process_count()
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id, **kwargs)
    _DISTRIBUTED_INITIALIZED = True
    return jax.process_count()


def make_hybrid_mesh(host_axes: dict, card_axes: dict, devices=None) -> Mesh:
    """Build a host x card mesh.

    ``host_axes`` ({name: size}) vary across hosts (slow network);
    ``card_axes`` vary within a host (NVLink between its cards).  Host axes
    lead, so reshaping the process-major ``jax.devices()`` order puts host
    boundaries exactly on them: collectives over the per-host axis names
    never cross hosts.  Every card of a host reaches every other at the
    same rate, so no finer device order is needed.
    """
    names = tuple(host_axes.keys()) + tuple(card_axes.keys())
    shape = tuple(host_axes.values()) + tuple(card_axes.values())
    n = int(np.prod(shape))
    if devices is None:
        devices = jax.devices()
    assert n <= len(devices), f"need {n} devices, have {len(devices)}"
    return Mesh(np.asarray(devices[:n]).reshape(shape), names)
