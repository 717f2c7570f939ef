"""chip_smoke.py on the CPU: its standard-library schema check gives
jsonschema's verdicts on the metrics records a port run writes (valid, and
each of several broken copies invalid), and the script refuses to run,
printing no result, without a GPU or outside the repository."""

import copy
import json
import os
import shutil
import subprocess
import sys

import jsonschema
import pytest
import torch

import chip_smoke
from distributed_learning_simulator_tpu_torch.config import ExperimentConfig
from distributed_learning_simulator_tpu_torch.simulator import run_simulation

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def schema():
    with open(os.path.join(_REPO, chip_smoke.SCHEMA)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    cfg = ExperimentConfig(
        dataset_name="synthetic", model_name="mlp", worker_number=4,
        round=2, batch_size=32, n_train=256, n_test=64, device="cpu",
        participation_fraction=0.5, log_level="WARNING",
        log_root=str(tmp_path_factory.mktemp("log")))
    return run_simulation(cfg)["history"]


def _broken(rec):
    """Copies of ``rec`` that the schema must reject."""
    out = []
    for field, value in (("round", "zero"), ("test_loss", None),
                         ("round", -1), ("round_seconds", "fast")):
        bad = copy.deepcopy(rec)
        bad[field] = value
        out.append(bad)
    missing = copy.deepcopy(rec)
    del missing["test_accuracy"]
    out.append(missing)
    return out


def test_schema_errors_agree_with_jsonschema(schema, records):
    validator = jsonschema.Draft7Validator(schema)
    for rec in records:
        assert validator.is_valid(rec)
        assert chip_smoke.schema_errors(rec, schema) == []
        for bad in _broken(rec):
            assert not validator.is_valid(bad)
            assert chip_smoke.schema_errors(bad, schema), bad


def test_refuses_without_a_gpu_or_outside_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the script would run")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(_REPO, "chip_smoke.py"), alone)
    for cwd, script in ((_REPO, "chip_smoke.py"), (tmp_path, str(alone))):
        proc = subprocess.run(
            [sys.executable, script, "--out", str(tmp_path / "out")],
            cwd=cwd, capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
