"""SMP_omega toy-molecule training demo.

The twin of the reference's flagship demo
(``tests/test_SMP_omega.cpp:149-210``): train second-order steerable message
passing on CH4/NH3/H2O/C2H4 with regression target = number of atoms, then
save/load the model and predict.

Run: python examples/train_smp_omega.py
"""

import time

from graphflow_tpu.models import SMP_omega
from graphflow_tpu.utils.datasets import toy_molecules


def main():
    graphs, targets = toy_molecules()
    model = SMP_omega(max_nVertices=10, max_receptive_field=4, nLevels=2,
                      nChanels=10, nFeatures=4, nDepth=5)

    nEpochs, lr = 256, 1e-3
    t0 = time.time()
    for epoch in range(nEpochs):
        loss_before, loss_after = model.BatchLearn(graphs, targets, lr)
        if epoch % 32 == 0:
            print(f"epoch {epoch:4d}: loss {loss_before:.4f} -> {loss_after:.4f}")
    print(f"trained {nEpochs} epochs in {time.time() - t0:.1f}s")

    model.save_model("SMP_omega-model.dat")
    model.load_model("SMP_omega-model.dat")

    for g, t in zip(graphs, targets):
        print(f"target {t:.0f}  predict {model.Predict(g):.3f}")


if __name__ == "__main__":
    main()
