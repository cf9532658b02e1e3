"""Multi-device data-parallel training demo.

The replacement for the reference's thread-replica data parallelism
(``tests/test_SMP_omega_multithreads.cpp``): shard the molecule batch over a
device mesh, psum gradients, one optimizer step — all one SPMD program.

Run (on a multi-chip host, or CPU with
XLA_FLAGS=--xla_force_host_platform_device_count=8):
    python examples/multichip_data_parallel.py
"""

import jax

from graphflow_tpu import parallel
from graphflow_tpu.models import SMP_omega
from graphflow_tpu.utils.datasets import toy_molecules


def main():
    devices = jax.devices()
    n = len(devices)
    print(f"{n} device(s): {devices[0].device_kind}")

    model = SMP_omega(max_nVertices=10, max_receptive_field=4, nLevels=2,
                      nChanels=10, nFeatures=4, nDepth=5)
    graphs, targets = toy_molecules()
    reps = max(1, (2 * n) // len(graphs))
    graphs, targets = graphs * reps, targets * reps
    graphs, targets = graphs[:len(graphs) - len(graphs) % n], \
        targets[:len(targets) - len(targets) % n]

    mesh = parallel.make_mesh({"data": n}, devices=devices)
    step = parallel.make_dp_train_step(model._loss, model.opt, mesh)
    batch = parallel.shard_batch(model._stack(graphs, targets), mesh)
    params = parallel.replicate(model.params, mesh)
    state = parallel.replicate(model.opt_state, mesh)

    for epoch in range(64):
        params, state, loss = step(params, state, batch, 1e-3)
        if epoch % 8 == 0:
            print(f"epoch {epoch:3d}: loss {float(loss):.4f}")

    model.params = jax.device_get(params)
    print("predictions:", [round(model.Predict(g), 2) for g in graphs[:4]])


if __name__ == "__main__":
    main()
