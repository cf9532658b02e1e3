"""Partitioned-graph execution tests: vertex sharding + targeted halo
exchange must be exact vs the single-device forward AND the partitioned
train step must be exact vs the single-device train step (8-way virtual
CPU mesh)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from graphflow_tpu.core import prep
from graphflow_tpu.models.smp2d import SMP2DConfig, init_smp2d_params, \
    smp2d_forward
from graphflow_tpu.optim.optimizers import make_optimizer
from graphflow_tpu.ops import losses
from graphflow_tpu.parallel import mesh as mesh_lib
from graphflow_tpu.parallel.partition import (
    plan_partition, plan_partition_batch, make_partitioned_forward,
    make_partitioned_train_step, shard_inputs,
)
from graphflow_tpu.utils.datasets import random_graph
from graphflow_tpu.core import batching


N_SHARDS = 8


@pytest.fixture(scope="module")
def setup():
    V = 24  # divisible by 8
    g = random_graph(V, 0.25, seed=5)
    cfg = SMP2DConfig(max_nVertices=V, max_receptive_field=4, nLevels=2,
                      nChanels=6, nFeatures=4, nDepth=3)
    params = init_smp2d_params(jax.random.PRNGKey(0), cfg)
    pg = prep.prepare_graph(g, cfg.nLevels, cfg.max_nVertices,
                            cfg.max_receptive_field, cfg.nDepth)
    return g, cfg, params, pg


def test_plan_partition_shapes(setup):
    _, cfg, _, pg = setup
    plan = plan_partition(pg, N_SHARDS)
    assert plan.Vs == cfg.max_nVertices // N_SHARDS
    assert len(plan.shift_sizes) == N_SHARDS - 1
    # remapped neighbor indices stay in the extended buffer range
    assert plan.nbr_loc.max() < plan.Vs + sum(plan.shift_sizes)
    assert plan.nbr_ag.max() < plan.Vs + N_SHARDS * plan.H
    # interior prefix really is interior: rows [0, Vi) only reference local
    Vi = plan.n_interior
    if Vi > 0:
        assert plan.nbr_loc[:, :, :, :Vi, :].max() < plan.Vs


def test_targeted_halo_is_smaller(setup):
    """The whole point: per-pair exchange receives fewer rows than the
    all_gather broadcast of every shard's full export union."""
    _, _, _, pg = setup
    plan = plan_partition(pg, N_SHARDS)
    assert plan.rows_targeted < plan.rows_allgather
    # and less than full replication of the vertex set
    assert plan.rows_targeted < pg.vmask.shape[0]


@pytest.mark.parametrize("halo", ["targeted", "all_gather"])
def test_partitioned_forward_matches_single_device(setup, halo):
    _, cfg, params, pg = setup
    plan = plan_partition(pg, N_SHARDS)
    m = mesh_lib.make_mesh({"graph": N_SHARDS}, devices=jax.devices("cpu"))
    fwd = make_partitioned_forward(cfg, plan, m, halo=halo)
    pred_p, feat_p = fwd(params, shard_inputs(plan))

    batch = batching.stack_graphs([pg])
    g0 = jax.tree_util.tree_map(lambda x: x[0], batch)
    pred_s, feat_s = smp2d_forward(params, g0, cfg)

    np.testing.assert_allclose(float(pred_p), float(pred_s), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(feat_p), np.asarray(feat_s),
                               rtol=1e-4, atol=1e-5)


def test_partitioned_train_step_matches_single_device(setup):
    """One step on a 2x4 data x graph mesh == one step of the single-device
    batched train step (same params, same optimizer)."""
    _, cfg, params, _ = setup
    n_data, n_graph = 2, 4
    V = cfg.max_nVertices
    graphs = [random_graph(V, 0.25, seed=s) for s in (5, 6, 7, 8)]
    targets = np.array([float(g.nVertices) for g in graphs], np.float32)
    pgs = [prep.prepare_graph(g, cfg.nLevels, V, cfg.max_receptive_field,
                              cfg.nDepth) for g in graphs]

    plan = plan_partition_batch(pgs, n_graph)
    m = mesh_lib.make_mesh({"data": n_data, "graph": n_graph},
                           devices=jax.devices("cpu"))
    opt_p = make_optimizer("adam")
    step = make_partitioned_train_step(cfg, plan, opt_p, m)
    params_p, state_p, loss_p = step(
        params, opt_p.init(params), shard_inputs(plan),
        jnp.asarray(targets), 0.01)

    # single-device reference step
    opt_s = make_optimizer("adam")
    batch = batching.stack_graphs(pgs, targets)

    def batch_loss(p):
        def one(g, t):
            pred, _ = smp2d_forward(p, g, cfg)
            return losses.squared_loss(pred, t)
        return jax.vmap(one)(batch, batch["target"]).sum()

    loss_s, grads = jax.value_and_grad(batch_loss)(params)
    params_s, _ = opt_s.update(params, opt_s.init(params), grads, 0.01,
                               nBatch=len(graphs))

    np.testing.assert_allclose(float(loss_p), float(loss_s), rtol=1e-4)
    for (ka, a), (kb, b) in zip(
            jax.tree_util.tree_leaves_with_path(params_p),
            jax.tree_util.tree_leaves_with_path(params_s)):
        # f32 psum reassociation noise passes through Adam's m/sqrt(v);
        # the reference-faithful nBatch Adam is UNCORRECTED (round 5), so
        # first-step updates are ~3.16x larger and near-zero gradients
        # amplify the noise further (the sharp partitioning-exactness gate
        # is the loss equality above).
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=3e-2, atol=2e-4, err_msg=str(ka))


@pytest.mark.parametrize("n_data,n_graph", [(2, 4), (1, 8), (4, 2)])
def test_partitioned_train_step_gradient_is_exact(setup, n_data, n_graph):
    """The gradient the partitioned step applies equals the single-device
    batch gradient, read from Adam's first moment m = 0.1 g / nBatch
    (linear in g, unlike the step itself, which is invariant to a
    gradient's scale and so hid a gradient counted once per graph shard)."""
    _, cfg, params, _ = setup
    V = cfg.max_nVertices
    graphs = [random_graph(V, 0.25, seed=s) for s in range(4)]
    targets = np.array([float(g.nVertices) for g in graphs], np.float32)
    pgs = [prep.prepare_graph(g, cfg.nLevels, V, cfg.max_receptive_field,
                              cfg.nDepth) for g in graphs]
    plan = plan_partition_batch(pgs, n_graph)
    m = mesh_lib.make_mesh({"data": n_data, "graph": n_graph},
                           devices=jax.devices("cpu"))
    opt = make_optimizer("adam")
    _, state_p, _ = make_partitioned_train_step(cfg, plan, opt, m)(
        params, opt.init(params), shard_inputs(plan), jnp.asarray(targets),
        0.01)

    def batch_loss(p):
        batch = batching.stack_graphs(pgs, targets)
        return jax.vmap(lambda g, t: losses.squared_loss(
            smp2d_forward(p, g, cfg)[0], t))(batch, batch["target"]).sum()

    _, state_s = opt.update(params, opt.init(params),
                            jax.grad(batch_loss)(params), 0.01,
                            nBatch=len(graphs))
    for a, b in zip(jax.tree_util.tree_leaves(state_p["m"]),
                    jax.tree_util.tree_leaves(state_s["m"])):
        a, b = np.asarray(a), np.asarray(b)
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


def test_partitioned_gradients_flow(setup):
    _, cfg, params, pg = setup
    plan = plan_partition(pg, N_SHARDS)
    m = mesh_lib.make_mesh({"graph": N_SHARDS}, devices=jax.devices("cpu"))
    fwd = make_partitioned_forward(cfg, plan, m)
    inputs = shard_inputs(plan)

    def loss(p):
        pred, _ = fwd(p, inputs)
        return (pred - 3.0) ** 2

    grads = jax.grad(loss)(params)
    gn = float(jnp.abs(grads["H"]).sum())
    assert np.isfinite(gn) and gn > 0


def test_partitioned_nondivisible_vertex_count():
    """V not divisible by n_shards: the plan pads the last shard with inert
    vertices and the forward still matches the single-device forward."""
    V = 21  # 21 % 8 != 0 -> padded to 24
    g = random_graph(V, 0.3, seed=9)
    cfg = SMP2DConfig(max_nVertices=V, max_receptive_field=4, nLevels=2,
                      nChanels=6, nFeatures=4, nDepth=3)
    params = init_smp2d_params(jax.random.PRNGKey(1), cfg)
    pg = prep.prepare_graph(g, cfg.nLevels, V, cfg.max_receptive_field,
                            cfg.nDepth)
    plan = plan_partition(pg, N_SHARDS)
    assert plan.Vs * N_SHARDS == 24
    m = mesh_lib.make_mesh({"graph": N_SHARDS}, devices=jax.devices("cpu"))
    fwd = make_partitioned_forward(cfg, plan, m)
    pred_p, feat_p = fwd(params, shard_inputs(plan))

    batch = batching.stack_graphs([pg])
    g0 = jax.tree_util.tree_map(lambda x: x[0], batch)
    pred_s, feat_s = smp2d_forward(params, g0, cfg)
    np.testing.assert_allclose(float(pred_p), float(pred_s), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(feat_p), np.asarray(feat_s),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("contraction", [4, 10, 50])
def test_partitioned_forward_other_contractions(contraction):
    """The partitioned path covers the whole contraction family
    (SMP_gamma / ver6 / ver7), not just the 18-case flagship."""
    V = 16
    g = random_graph(V, 0.3, seed=11)
    cfg = SMP2DConfig(max_nVertices=V, max_receptive_field=4, nLevels=1,
                      nChanels=4, nFeatures=4, nDepth=2,
                      contraction=contraction)
    params = init_smp2d_params(jax.random.PRNGKey(2), cfg)
    pg = prep.prepare_graph(g, cfg.nLevels, V, cfg.max_receptive_field,
                            cfg.nDepth)
    plan = plan_partition(pg, 4)
    m = mesh_lib.make_mesh({"graph": 4}, devices=jax.devices("cpu")[:4])
    fwd = make_partitioned_forward(cfg, plan, m)
    pred_p, feat_p = fwd(params, shard_inputs(plan))

    batch = batching.stack_graphs([pg])
    g0 = jax.tree_util.tree_map(lambda x: x[0], batch)
    pred_s, feat_s = smp2d_forward(params, g0, cfg)
    np.testing.assert_allclose(float(pred_p), float(pred_s), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(feat_p), np.asarray(feat_s),
                               rtol=1e-4, atol=1e-5)


def test_partitioned_classification_train_step():
    """Classification head (LogLoss over psum'd class scores) trains on the
    partitioned path and matches the single-device step."""
    V, nC = 16, 3
    graphs = [random_graph(V, 0.3, seed=s) for s in (1, 2)]
    labels = np.array([0, 2], np.int32)
    cfg = SMP2DConfig(max_nVertices=V, max_receptive_field=4, nLevels=1,
                      nChanels=4, nFeatures=4, nDepth=2, nClasses=nC)
    params = init_smp2d_params(jax.random.PRNGKey(3), cfg)
    pgs = [prep.prepare_graph(g, cfg.nLevels, V, cfg.max_receptive_field,
                              cfg.nDepth) for g in graphs]
    plan = plan_partition_batch(pgs, 4)
    m = mesh_lib.make_mesh({"data": 2, "graph": 4},
                           devices=jax.devices("cpu"))
    opt_p = make_optimizer("adam")
    step = make_partitioned_train_step(cfg, plan, opt_p, m)
    params_p, _, loss_p = step(params, opt_p.init(params),
                               shard_inputs(plan), jnp.asarray(labels), 0.01)

    batch = batching.stack_graphs(pgs, labels.astype(np.float32))

    def batch_loss(p):
        def one(g, t):
            scores, _ = smp2d_forward(p, g, cfg)
            return losses.log_loss(scores, t.astype(jnp.int32))
        return jax.vmap(one)(batch, batch["target"]).sum()

    loss_s, grads = jax.value_and_grad(batch_loss)(params)
    np.testing.assert_allclose(float(loss_p), float(loss_s), rtol=1e-4)
    opt_s = make_optimizer("adam")
    params_s, _ = opt_s.update(params, opt_s.init(params), grads, 0.01,
                               nBatch=2)
    for (ka, a), (kb, b) in zip(
            jax.tree_util.tree_leaves_with_path(params_p),
            jax.tree_util.tree_leaves_with_path(params_s)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=5e-3, atol=1e-5, err_msg=str(ka))


def test_comm_per_level_accounting(setup):
    _, _, _, pg = setup
    plan = plan_partition(pg, N_SHARDS)
    assert plan.comm_per_level is not None
    assert len(plan.comm_per_level) == 2  # nLevels
    for row in plan.comm_per_level:
        assert row["targeted_max"] <= row["allgather"]
        assert 0 <= row["targeted_mean"] <= row["targeted_max"]
    table = plan.comm_table(row_bytes=4 * 5 * 5 * 6)
    assert "targeted_max" in table and "KiB" in table
