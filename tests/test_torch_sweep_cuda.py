"""The sweep's experiment-axis mesh over two cards (sweep/engine.py
``_run_fleet``): each group of experiments trains and evaluates on its
own card, and the round's one metric fetch takes every value from the
program's card. On the CPU every mesh slot is the one host device, so this
needs two NVIDIA GPUs and skips without them; on such a machine (which
need not have JAX):

    python -m pytest --noconftest tests/test_torch_sweep_cuda.py -q

A two-seed MLP fleet with ``mesh_devices=2`` against the same fleet on one
card, every record within rel 1e-5 (tests/test_torch_sweep.py
``test_fleet_mesh_packing``'s bound): each card's program holds one
experiment's models where the one-card program holds both.
"""

import dataclasses

import pytest
import torch

from distributed_learning_simulator_tpu_torch.config import ExperimentConfig
from distributed_learning_simulator_tpu_torch.simulator import run_sweep
from distributed_learning_simulator_tpu_torch.sweep import SweepSpec

pytestmark = pytest.mark.cuda


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs: the experiment axis over cards")


def test_fleet_over_two_cards_as_on_one(two_cards):
    base = ExperimentConfig(
        dataset_name="synthetic", model_name="mlp", worker_number=8,
        round=2, epoch=1, learning_rate=0.1, batch_size=16, n_train=256,
        n_test=128, log_level="WARNING", device="cuda")
    points = [{"seed": 0}, {"seed": 1}]
    one = run_sweep(SweepSpec(base, points, strategy="vmapped"))
    meshed = run_sweep(SweepSpec(dataclasses.replace(base, mesh_devices=2),
                                 points, strategy="vmapped"))
    for pm, po in zip(meshed["points"], one["points"], strict=True):
        assert pm["seed"] == po["seed"]
        for rm, ro in zip(pm["history"], po["history"], strict=True):
            assert rm.get("cohort_hash") == ro.get("cohort_hash")
            for k in ("test_accuracy", "test_loss", "mean_client_loss"):
                assert rm[k] == pytest.approx(ro[k], rel=1e-5), (k, rm, ro)
