"""The port's run loop, CLI and config (simulator.py, config.py,
factory.py) against the JAX package's surface: a tiny end-to-end run on
the CPU, the config fields and defaults, the CLI probes, and the rule that
importing the port loads no JAX."""

import dataclasses
import json
import logging
import os
import subprocess
import sys

import jsonschema
import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu.config import (
    ExperimentConfig as JaxConfig,
)
from distributed_learning_simulator_tpu.sweep import spec as jspec
from distributed_learning_simulator_tpu.utils import reporting as jreporting
from distributed_learning_simulator_tpu_torch.config import (
    ExperimentConfig,
    get_config,
)
from distributed_learning_simulator_tpu_torch.simulator import (
    main,
    run_simulation,
)
from distributed_learning_simulator_tpu_torch.utils import reporting
from distributed_learning_simulator_tpu_torch.utils.logging import get_logger

_SCHEMA = os.path.join(os.path.dirname(__file__), "data",
                       "metrics_record.schema.json")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = [
    "--dataset_name", "synthetic", "--model_name", "resnet18",
    "--distributed_algorithm", "fed", "--worker_number", "4", "--round", "3",
    "--epoch", "1", "--learning_rate", "0.1", "--momentum", "0.9",
    "--batch_size", "8", "--n_train", "96", "--n_test", "32",
    "--partition", "dirichlet", "--dirichlet_alpha", "0.5",
    "--client_chunk_size", "2", "--local_compute_dtype", "bfloat16",
    "--model_args", '{"stage_sizes": [1, 1], "width": 8}',
    "--log_level", "INFO", "--device", "cpu",
]


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_cli_end_to_end_on_cpu(tmp_path):
    """Finite losses, the ``round N:`` lines, and metrics.jsonl records
    that validate against the checked-in schema."""
    handler = _Lines()
    get_logger().addHandler(handler)
    try:
        result = main(TINY + ["--log_root", str(tmp_path)])
    finally:
        get_logger().removeHandler(handler)
    history = result["history"]
    assert [h["round"] for h in history] == [0, 1, 2]
    assert all(np.isfinite(h["test_loss"]) for h in history)
    rounds = [ln for ln in handler.lines if ln.startswith("round ")]
    assert len(rounds) == 3 and "test_acc=" in rounds[0]
    (metrics,) = tmp_path.glob("fed/synthetic/resnet18/*_artifacts/"
                               "metrics.jsonl")
    with open(_SCHEMA) as f:
        schema = json.load(f)
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert records == history
    for rec in records:
        jsonschema.validate(rec, schema)
    assert set(result) >= {
        "global_params", "client_state", "history", "algorithm",
        "final_accuracy", "total_seconds", "client_rounds_per_sec",
        "client_chunk_size",
    }


def test_training_reduces_loss_on_learnable_data():
    cfg = ExperimentConfig(
        dataset_name="synthetic", model_name="resnet18", worker_number=2,
        round=4, epoch=1, learning_rate=0.05, momentum=0.9, batch_size=16,
        n_train=128, n_test=64, log_level="WARNING", device="cpu",
        dataset_args={"shape": (8, 8, 3), "difficulty": 0.3},
        model_args={"stage_sizes": [1], "width": 8},
    )
    hist = run_simulation(cfg, setup_logging=False)["history"]
    assert hist[-1]["test_loss"] < hist[0]["test_loss"]


def test_config_fields_and_defaults_match_jax():
    jax_fields = {f.name: f for f in dataclasses.fields(JaxConfig)}
    port_fields = {f.name: f for f in dataclasses.fields(ExperimentConfig)}
    assert set(port_fields) - set(jax_fields) == {"device"}
    assert port_fields["device"].default == "cuda"
    # The one deliberate difference of default: the cost model's anchor
    # is the card that made the trace (the JAX default is a TPU row).
    assert port_fields["cost_model_topology"].default == "h100-sxm-1"
    for name, jf in jax_fields.items():
        if name == "cost_model_topology":
            continue
        pf = port_fields[name]
        if jf.default_factory is not dataclasses.MISSING:
            assert pf.default_factory() == jf.default_factory(), name
        else:
            assert pf.default == jf.default, name
    for frac, n in ((1.0, 7), (0.3, 10), (0.01, 10), (0.5, 1)):
        assert ExperimentConfig(participation_fraction=frac).cohort_size(n) == (
            JaxConfig(participation_fraction=frac).cohort_size(n)
        )
    # The copied reporting module hashes a config exactly as the JAX one.
    jcfg = JaxConfig(model_name="resnet18", worker_number=7)
    assert reporting.config_hash(jcfg) == jreporting.config_hash(jcfg)
    assert reporting.METRICS_SCHEMA_VERSION == (
        jreporting.METRICS_SCHEMA_VERSION
    )


def test_probes_raise_as_in_jax():
    with pytest.raises(RuntimeError, match="registered") as err:
        run_simulation(dataclasses.replace(
            get_config(TINY), distributed_algorithm="bogus"),
            setup_logging=False)
    for name in ("fed", "sign_SGD", "fed_quant", "multiround_shapley_value",
                 "GTG_shapley_value"):
        assert name in str(err.value)
    with pytest.raises(ValueError, match="worker_number"):
        get_config(TINY + ["--worker_number", "0"])


@pytest.mark.parametrize("flags,item", [
    (["--client_residency", "streamed", "--mesh_devices", "2"], "item 17"),
    (["--mesh_devices", "2"], "item 17"),
    (["--population", "dynamic", "--client_residency", "streamed",
      "--participation_sampler", "hashed", "--participation_fraction", "0.5",
      "--multihost", "true"], "item 17"),
    (["--multihost", "true"], "item 17"),
])
def test_unported_features_refuse(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        run_simulation(get_config(TINY + flags), setup_logging=False)


@pytest.mark.parametrize("flags", [
    ["--sweep_seeds", "0,1"],
    ["--sweep_points", "learning_rate=0.1,0.2"],
])
def test_cli_sweeps(flags):
    """The sweep knobs route ``main`` to ``run_sweep``: a seed fleet
    returns a sweep result; a ``--sweep_points`` that is not JSON raises
    the JAX package's error."""
    if flags[0] == "--sweep_seeds":
        out = main(TINY + flags + ["--round", "2"])
        assert "strategy" in out and out["strategy"] == "vmapped"
        assert [p["seed"] for p in out["points"]] == [0, 1]
        return
    with pytest.raises(ValueError) as port_err:
        main(TINY + flags)
    with pytest.raises(ValueError) as jax_err:
        jspec._parse_points_field(flags[1])
    assert type(port_err.value) is type(jax_err.value)
    assert str(port_err.value) == str(jax_err.value)


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py covers it")
    with pytest.raises(RuntimeError, match="is_available"):
        run_simulation(get_config(TINY + ["--device", "cuda"]),
                       setup_logging=False)


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import distributed_learning_simulator_tpu_torch.simulator\n"
        "import distributed_learning_simulator_tpu_torch.models.bridge\n"
        "import distributed_learning_simulator_tpu_torch.models.registry\n"
        "import distributed_learning_simulator_tpu_torch.data.formats\n"
        "import distributed_learning_simulator_tpu_torch"
        ".simulator_heterogeneous\n"
        "import distributed_learning_simulator_tpu_torch.__main__\n"
        "import distributed_learning_simulator_tpu_torch.execution.threaded\n"
        "import distributed_learning_simulator_tpu_torch.telemetry\n"
        "import distributed_learning_simulator_tpu_torch.sweep\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'distributed_learning_simulator_tpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=_REPO,
                   timeout=120)
