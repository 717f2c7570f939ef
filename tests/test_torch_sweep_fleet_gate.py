"""chip_smoke.py's gate on ``sweep_fleet``'s round 0 (``FirstTraining``,
``leaf_differences``, ``round0_leaves_gate``) on the CPU, on a small MLP
fleet: the fleet keeps its first training chunk's rows (experiment-major)
and its first aggregate, the comparison names the first leaf that
differs, and the gate fails unless every point is bitwise, in f32 and in
bf16 local training (a fleet's rows against its points' solo runs)."""

import dataclasses

import pytest
import torch

import chip_smoke
from distributed_learning_simulator_tpu_torch.config import ExperimentConfig
from distributed_learning_simulator_tpu_torch.data.registry import get_dataset
from distributed_learning_simulator_tpu_torch.simulator import (
    build_client_data,
    run_sweep,
)

MLP = dict(
    dataset_name="synthetic", model_name="mlp", distributed_algorithm="fed",
    worker_number=4, round=1, epoch=1, learning_rate=0.1, batch_size=16,
    n_train=128, n_test=64, log_level="WARNING",
    dataset_args={"difficulty": 0.5}, compilation_cache_dir=None,
    device="cpu", client_chunk_size=4, sweep_strategy="vmapped",
)


def _first_training(tmp_path, seeds: str, dtype: str = "float32"):
    base = ExperimentConfig(log_root=str(tmp_path),
                            local_compute_dtype=dtype, **MLP)
    ds = get_dataset("synthetic", n_train=128, n_test=64, seed=base.seed,
                     difficulty=0.5)
    cd = build_client_data(base, ds)
    with chip_smoke.FirstTraining() as first:
        run_sweep(dataclasses.replace(base, sweep_seeds=seeds), dataset=ds,
                  client_data=cd)
    return first


def test_first_training_keeps_the_run_s_first_chunk(tmp_path):
    runs = [_first_training(tmp_path, "0,1") for _ in range(2)]
    assert runs[0].trained.shape == (2 * 4, sum(runs[0].layout.numels))
    assert runs[0].globals.shape == (2, sum(runs[0].layout.numels))
    assert torch.equal(runs[0].trained, runs[1].trained)
    with pytest.raises(SystemExit):
        chip_smoke.leaf_differences(torch, runs[0].layout, runs[0].trained,
                                    runs[0].trained[:4])


def test_leaf_differences_names_the_first_differing_leaf(tmp_path):
    first = _first_training(tmp_path, "0")
    rows, layout = first.trained, first.layout
    same = chip_smoke.leaf_differences(torch, layout, rows, rows.clone())
    assert same["first"] is None and same["differing_leaves"] == 0
    assert same["leaves"] == len(layout.names)
    moved = rows.clone()
    moved[:, -1] += 1.0
    d = chip_smoke.leaf_differences(torch, layout, rows, moved)
    assert d["first"]["leaf"] == layout.names[-1]
    assert d["differing_leaves"] == 1
    assert d["max_abs_diff"] == pytest.approx(1.0, rel=1e-6)


@pytest.mark.parametrize("moved", [False, True])
def test_round0_leaves_gate_fails_unless_every_point_is_bitwise(tmp_path,
                                                                moved):
    first = _first_training(tmp_path, "0")
    rows, layout = first.trained, first.layout
    other = rows.clone()
    if moved:
        other[:, 0] = torch.nextafter(other[:, 0], other[:, 0] + 1)
    leaves = {0: chip_smoke.leaf_differences(torch, layout, rows,
                                             rows.clone()),
              1: chip_smoke.leaf_differences(torch, layout, rows, other)}
    if not moved:
        chip_smoke.round0_leaves_gate("f32", leaves)
        return
    with pytest.raises(SystemExit):
        chip_smoke.round0_leaves_gate("f32", leaves)
    assert leaves[1]["first"]["leaf"] == layout.names[0]


@pytest.mark.parametrize("moved", [False, True])
def test_bf16_fleet_rows_are_its_solo_runs(tmp_path, moved):
    """A bf16 fleet of two seeds against each seed's fleet of one (the solo
    chunk): the gate passes bitwise, and fails naming the leaf once one
    row of a point is moved by one ulp."""
    fleet = _first_training(tmp_path, "0,1", "bfloat16")
    layout, m = fleet.layout, MLP["client_chunk_size"]
    assert fleet.trained.shape == (2 * m, sum(layout.numels))
    leaves = {}
    for i, seed in enumerate("01"):
        solo = _first_training(tmp_path, seed, "bfloat16").trained
        rows = fleet.trained[i * m:(i + 1) * m].clone()
        if moved and i == 1:
            rows[2, -1] = torch.nextafter(rows[2, -1], rows[2, -1] + 1)
        leaves[i] = chip_smoke.leaf_differences(torch, layout, rows, solo)
    if not moved:
        chip_smoke.round0_leaves_gate("bf16", leaves)
        return
    assert leaves[0]["first"] is None
    with pytest.raises(SystemExit):
        chip_smoke.round0_leaves_gate("bf16", leaves)
    assert leaves[1]["first"]["leaf"] == layout.names[-1]
