"""Multi-host scaffolding dryrun: a 2 (host) x 4 (card) hybrid mesh
on virtual CPU devices.  The reference has no distributed backend at all
(SURVEY.md section 2.8); these tests pin the mesh construction, collective
axis placement, and a DP train step psumming over BOTH axes.
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from graphflow_tpu import parallel
from graphflow_tpu.models import SMP_omega


def _toy_batch(model, n):
    from graphflow_tpu.utils.datasets import toy_molecules
    graphs, targets = toy_molecules()
    gs = [graphs[i % 4] for i in range(n)]
    ts = [targets[i % 4] for i in range(n)]
    return model._stack(gs, ts)


def test_init_distributed_single_process_noop():
    assert parallel.init_distributed() == jax.process_count() == 1


def test_hybrid_mesh_shape_and_axis_order():
    mesh = parallel.make_hybrid_mesh({"host": 2}, {"data": 4},
                                     devices=jax.devices("cpu"))
    assert mesh.axis_names == ("host", "data")
    assert mesh.devices.shape == (2, 4)
    # process-major reshape: cards of one "host" are contiguous, so the
    # per-host axis ("data") never crosses a host boundary
    flat = np.asarray(jax.devices("cpu")[:8]).reshape(2, 4)
    assert (mesh.devices == flat).all()


def test_hybrid_mesh_collectives():
    """psum over the per-host axis stays within a host row; over both axes it is
    the global sum."""
    mesh = parallel.make_hybrid_mesh({"host": 2}, {"data": 4},
                                     devices=jax.devices("cpu"))

    def f(x):
        row = jax.lax.psum(x, "data")     # within a host
        both = jax.lax.psum(x, ("host", "data"))
        return row, both

    x = jnp.arange(8.0)
    row, both = jax.jit(shard_map(f, mesh=mesh,
                                  in_specs=P(("host", "data")),
                                  out_specs=(P(("host", "data")),
                                             P(("host", "data")))))(x)
    # shard i holds value i; host 0 rows sum 0+1+2+3=6, host 1: 4+5+6+7=22
    np.testing.assert_allclose(np.asarray(row),
                               [6, 6, 6, 6, 22, 22, 22, 22])
    np.testing.assert_allclose(np.asarray(both), [28] * 8)


def test_dp_train_step_on_hybrid_mesh():
    """The DP train step psums gradients over host AND card axes; its loss
    must equal the single-device batch loss."""
    model = SMP_omega(max_nVertices=8, max_receptive_field=3, nLevels=1,
                      nChanels=4, nFeatures=4, nDepth=2, seed=0)
    mesh = parallel.make_hybrid_mesh({"host": 2}, {"data": 4},
                                     devices=jax.devices("cpu"))
    step = parallel.make_dp_train_step(model._loss, model.opt, mesh,
                                       axis=("host", "data"))
    batch = _toy_batch(model, 8)
    loss_single = float(model._batch_loss(model.params, batch))

    sbatch = parallel.shard_batch(batch, mesh, axis=("host", "data"))
    params = parallel.replicate(model.params, mesh)
    state = parallel.replicate(model.opt_state, mesh)
    params, state, loss = step(params, state, sbatch, 0.001)
    np.testing.assert_allclose(float(loss), loss_single, rtol=1e-5)


def test_hybrid_mesh_multiprocess_gpu_host_mocked(monkeypatch):
    """With several processes (2 hosts x 4 GPUs), the process-major device
    order reshapes straight into the host x card mesh: each host's cards
    form one row, so collectives over the per-host axis stay on NVLink.
    The process count is mocked; the devices are the virtual CPU ones."""
    from graphflow_tpu.parallel import mesh as mesh_lib

    monkeypatch.setattr(jax, "process_count", lambda: 2)
    cpus = jax.devices("cpu")[:8]
    m = mesh_lib.make_hybrid_mesh({"host": 2}, {"data": 4}, devices=cpus)
    assert m.shape == {"host": 2, "data": 4}
    assert [d.id for d in m.devices[1]] == [d.id for d in cpus[4:8]]

    def f(x):
        return jax.lax.psum(x, "data"), jax.lax.psum(x, ("host", "data"))

    row, both = shard_map(f, mesh=m, in_specs=P(("host", "data")),
                          out_specs=(P(("host", "data")),
                                     P(("host", "data"))))(jnp.arange(8.0))
    np.testing.assert_allclose(np.asarray(row), [6] * 4 + [22] * 4)
    np.testing.assert_allclose(np.asarray(both), [28] * 8)
