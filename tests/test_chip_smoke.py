"""chip_smoke.py on the CPU: its phases at a tiny size with the devices
passed in, and its refusal to run anywhere but on a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import jax

import chip_smoke
from graphflow_tpu.models import SMP_omega
from graphflow_tpu.models.smp2d import SMP2DConfig

TINY = dict(max_nVertices=8, max_receptive_field=4, nLevels=2, nChanels=4,
            nFeatures=4, nDepth=2)


@pytest.fixture
def tiny():
    model = SMP_omega(**TINY, seed=0)
    graphs, targets = chip_smoke.make_batch(TINY["max_nVertices"], 4)
    return model, graphs, targets


def test_main_fails_on_cpu(capsys):
    with pytest.raises(RuntimeError, match="not gpu"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_fails(tmp_path):
    """Copied into a directory that holds nothing else of the repository,
    the script exits non-zero and prints no result."""
    shutil.copy(chip_smoke.__file__, tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_phase_gather_tiny(tiny):
    model, graphs, _ = tiny
    chip_smoke.phase_gather(model, graphs[0], jax.devices("cpu")[0])


def test_phases_train_predict_reference_tiny(tiny):
    model, graphs, targets = tiny
    chip_smoke.phase_train(model, graphs, targets, lr=1e-4)
    preds, feats, _, _ = chip_smoke.phase_predict(model, graphs)
    assert preds.shape == (4,) and feats.shape == (4, TINY["nChanels"])
    m16 = chip_smoke.bf16_model(model)
    preds_bf16 = np.asarray(m16.Threaded_Predict(graphs), np.float32)
    chip_smoke.phase_reference(model, graphs, targets, preds, feats,
                               preds_bf16, jax.devices("cpu")[0])


def test_four_device_path_tiny():
    """The --four comparisons (dryrun_multichip with a given config and
    batch, both legs at "highest") on 4 virtual CPU devices."""
    from __graft_entry__ import dryrun_multichip

    cfg = SMP2DConfig(**TINY)
    graphs, targets = chip_smoke.make_batch(TINY["max_nVertices"], 8)
    with jax.default_matmul_precision("highest"):
        errors = dryrun_multichip(4, cfg, graphs, targets)
    assert errors["dp_loss_rel"] <= 1e-5
    assert errors["partitioned_pred_rel"] <= 1e-4
    assert errors["partitioned_train_loss_rel"] <= 1e-4
