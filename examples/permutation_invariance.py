"""Permutation-invariance property demo.

The twin of ``tests/test_graph_permutation_invariant.cpp``: graph-level
``Feature()`` embeddings must be invariant under vertex relabeling (the
defining property of the Covariant Compositional Network construction).

Run: python examples/permutation_invariance.py
"""

import numpy as np

from graphflow_tpu.models import SMP_omega
from graphflow_tpu.utils.datasets import random_graph


def main():
    rng = np.random.default_rng(7)
    n = 10
    g = random_graph(n, 0.4, seed=7)
    model = SMP_omega(max_nVertices=n, max_receptive_field=5, nLevels=2,
                      nChanels=8, nFeatures=4, nDepth=3)

    f0 = model.Feature(g)
    print("graph feature:", np.round(f0, 4))
    for trial in range(5):
        perm = rng.permutation(n)
        fp = model.Feature(g.permuted(perm))
        gap = np.abs(f0 - fp).sum()
        print(f"permutation {trial}: L1 gap = {gap:.2e}")


if __name__ == "__main__":
    main()
