"""One configuration through both packages' ``run_simulation`` on the CPU,
from the same initial parameters (the JAX package's init, transplanted into
the port), with no injected draws: the port's own key chain must replay the
JAX package's. Shared by the port's end-to-end parity tests."""

import jax
import numpy as np
import torch

from distributed_learning_simulator_tpu.config import (
    ExperimentConfig as JaxConfig,
)
from distributed_learning_simulator_tpu.data.registry import (
    get_dataset as jax_get_dataset,
)
from distributed_learning_simulator_tpu.models.registry import (
    get_model as jax_get_model,
    init_params as jax_init_params,
)
from distributed_learning_simulator_tpu.simulator import (
    run_simulation as jax_run_simulation,
)
from distributed_learning_simulator_tpu_torch import simulator
from distributed_learning_simulator_tpu_torch.config import ExperimentConfig
from distributed_learning_simulator_tpu_torch.models.bridge import (
    params_from_jax,
)

HW = 8
#: A tiny ResNet on 8x8 synthetic images, f32 model arithmetic.
BASE = dict(
    dataset_name="synthetic", model_name="resnet18", worker_number=6,
    round=2, epoch=1, learning_rate=0.05, momentum=0.9, batch_size=4,
    n_train=96, n_test=32, partition="dirichlet", dirichlet_alpha=0.5,
    max_shard_size=16, client_chunk_size=2, eval_batch_size=16,
    model_args={"stage_sizes": [1], "width": 8, "dtype": "float32"},
    dataset_args={"shape": (HW, HW, 3)}, log_level="WARNING",
)


def run_both(monkeypatch, log_root=None, **changes):
    """``(jax_result, port_result)`` of one configuration (``BASE`` with
    ``changes``). With ``log_root`` both runs write their logs and
    artifacts under it (``<log_root>/jax``, ``<log_root>/port``)."""
    kw = dict(BASE, **changes)
    jcfg = JaxConfig(**kw)
    pcfg = ExperimentConfig(device="cpu", **kw)
    if log_root is not None:
        jcfg.log_root = str(log_root / "jax")
        pcfg.log_root = str(log_root / "port")
    jres = jax_run_simulation(jcfg, setup_logging=log_root is not None)
    ds = jax_get_dataset("synthetic", n_train=kw["n_train"],
                         n_test=kw["n_test"], seed=kw.get("seed", 0),
                         shape=(HW, HW, 3))
    jmodel = jax_get_model("resnet18", num_classes=ds.num_classes,
                           **kw["model_args"])
    init = params_from_jax(jax.device_get(
        jax_init_params(jmodel, ds.x_train[:1], seed=kw.get("seed", 0))))
    monkeypatch.setattr(
        simulator, "init_params",
        lambda model, seed=0: {k: v.clone() for k, v in init.items()},
    )
    pres = simulator.run_simulation(pcfg,
                                    setup_logging=log_root is not None)
    return jres, pres


def losses_of(result) -> np.ndarray:
    return np.asarray([r["test_loss"] for r in result["history"]])


def flat_params(result, names) -> torch.Tensor:
    """A run's final global model as one f32 vector in ``names`` order
    (the JAX result's tree is transplanted first)."""
    params = result["global_params"]
    if not isinstance(params, dict) or not all(
        isinstance(v, torch.Tensor) for v in params.values()
    ):
        params = params_from_jax(jax.device_get(params))
    return torch.cat([params[n].float().reshape(-1) for n in names])
