"""End-to-end accuracy band of the port against the JAX package, and the
new models through the port's CLI on the CPU.

The band: the JAX tests' own ``tiny_config`` (tests/conftest.py: MLP on
the synthetic dataset, 4 clients, 2 rounds, lr 0.1, batch 32) with seeds
0, 1 and 2, run by both packages with nothing injected (the port's own
init and key chain). Every round's test accuracy is within one test sample
(1/256) of the JAX package's and its test loss within rtol 1e-4: f32
arithmetic in both, so only operation order differs.

The CLI: ``--model_name cnn_tpu`` (the headline model, bf16 compute) and
``--model_name mlp`` run to the end with ``--device cpu`` and write
metrics.jsonl records that validate against the checked-in schema.
"""

import dataclasses
import json
import os

import jsonschema
import numpy as np
import pytest

from distributed_learning_simulator_tpu.simulator import (
    run_simulation as jax_run_simulation,
)
from distributed_learning_simulator_tpu_torch.config import ExperimentConfig
from distributed_learning_simulator_tpu_torch.simulator import (
    main,
    run_simulation,
)

_SCHEMA = os.path.join(os.path.dirname(__file__), "data",
                       "metrics_record.schema.json")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tiny_config_accuracy_band(tiny_config, seed):
    jcfg = dataclasses.replace(tiny_config, seed=seed)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)
              if f.name != "cost_model_topology"}  # a TPU row in JAX
    pcfg = ExperimentConfig(device="cpu", **fields)
    jhist = jax_run_simulation(jcfg, setup_logging=False)["history"]
    phist = run_simulation(pcfg, setup_logging=False)["history"]
    assert len(phist) == len(jhist) == 2
    for p, j in zip(phist, jhist):
        assert abs(p["test_accuracy"] - j["test_accuracy"]) <= 1 / 256
        np.testing.assert_allclose(p["test_loss"], j["test_loss"],
                                   rtol=1e-4)
        np.testing.assert_allclose(p["mean_client_loss"],
                                   j["mean_client_loss"], rtol=1e-4)


@pytest.mark.parametrize("model,extra", [
    ("cnn_tpu", ["--dataset_name", "cifar10", "--n_train", "200",
                 "--n_test", "100", "--batch_size", "25",
                 "--client_chunk_size", "0",
                 "--model_args", '{"width": 16}']),
    ("mlp", ["--dataset_name", "synthetic", "--n_train", "256",
             "--n_test", "128", "--batch_size", "32",
             "--augment", "none", "--reset_client_optimizer", "false",
             "--momentum", "0.9"]),
])
def test_cli_runs_the_new_models_on_cpu(tmp_path, model, extra):
    argv = ["--model_name", model, "--distributed_algorithm", "fed",
            "--worker_number", "4", "--round", "2", "--epoch", "1",
            "--learning_rate", "0.1", "--device", "cpu",
            "--log_level", "WARNING", "--log_root", str(tmp_path)] + extra
    result = main(argv)
    history = result["history"]
    assert [h["round"] for h in history] == [0, 1]
    assert all(np.isfinite(h["test_loss"]) for h in history)
    assert result["client_chunk_size"] == (4 if model == "cnn_tpu" else None)
    (metrics,) = tmp_path.glob(f"fed/*/{model}/*_artifacts/metrics.jsonl")
    with open(_SCHEMA) as f:
        schema = json.load(f)
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert records == history
    for rec in records:
        jsonschema.validate(rec, schema)
