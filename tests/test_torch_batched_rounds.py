"""Rounds over a chunk of clients at once: ``run_simulation`` of the port
with ``client_chunk_size`` > 1 against the JAX package's run at the same
chunk size, and against the port's own run at chunk 1 (the JAX package's way
of training one client at a time), on ``torch_runs.BASE``'s tiny ResNet.
Each run also counts the model's forwards, which shows that a chunk trains
as one program: ``chunks x steps`` training forwards, not ``clients x
steps``.

Tolerances (tests/test_torch_keychain.py's): f32 local state, test losses
at rtol 1e-4 and the final global model at rtol 1e-4 / atol 1e-5; bf16
local state, test losses at rtol 2e-3 (the stochastic rounding hashes the
f32 bits, so an ulp-level gradient difference redraws a coordinate);
fed_quant, the final model within three quantization levels per coordinate
and half a level on average, test losses at rtol 5e-3; Shapley utilities
within 2 / n_eval of the JAX run's and 1 / n_eval of the chunk-1 run's.

Every run here has functorch's per-example fallback disabled
(``engine.no_vmap_fallback``): an op without a batching rule raises.
"""

import contextlib
import glob
import pickle

import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu_torch import simulator
from distributed_learning_simulator_tpu_torch.config import ExperimentConfig
from distributed_learning_simulator_tpu_torch.models.resnet import ResNet18
from distributed_learning_simulator_tpu_torch.ops.quantize import (
    Segments,
    stochastic_quantize,
)
from distributed_learning_simulator_tpu_torch.parallel.engine import (
    no_vmap_fallback,
)
from test_torch_keychain import _names_and_numels
from torch_runs import BASE, flat_params, losses_of, run_both

N_EVAL = 32  # BASE's n_test


@pytest.fixture(autouse=True)
def _strict_vmap():
    with no_vmap_fallback():
        yield


@contextlib.contextmanager
def _forwards():
    """Counts the ResNet's training and evaluation forwards."""
    counts = {"train": 0, "eval": 0}

    def hook(module, args, output):
        if isinstance(module, ResNet18):
            counts["train" if torch.is_grad_enabled() else "eval"] += 1

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        yield counts
    finally:
        handle.remove()


def _three_runs(log_root=None, **changes):
    """The JAX run and the port's at ``changes``' chunk size, then the
    port's at chunk 1; with each port run's forward counts."""
    with _forwards() as batched:
        jres, pres = run_both(log_root=log_root, **changes)
    one = dict(BASE, **dict(changes, client_chunk_size=1))
    if log_root is not None:
        one["log_root"] = str(log_root / "port_chunk1")
    with _forwards() as single:
        ores = simulator.run_simulation(
            ExperimentConfig(device="cpu", **one),
            setup_logging=log_root is not None)
    return jres, pres, ores, batched, single


def _assert_f32_close(a, b):
    names, _ = _names_and_numels()
    np.testing.assert_allclose(losses_of(a), losses_of(b), rtol=1e-4)
    torch.testing.assert_close(flat_params(a, names), flat_params(b, names),
                               rtol=1e-4, atol=1e-5)


def test_fed_plain_chunks_train_a_chunk_per_step():
    """No size-aware schedule: 6 clients in chunks of 3, 4 steps a round,
    2 rounds: 16 training forwards, against 48 at chunk 1."""
    jres, pres, ores, batched, single = _three_runs(
        client_chunk_size=3, bucket_client_work=False)
    assert pres["client_chunk_size"] == 3
    _assert_f32_close(pres, jres)
    _assert_f32_close(pres, ores)
    assert batched["train"] == 2 * 2 * 4
    assert single["train"] == 2 * 6 * 4


def test_fed_bucketed_groups_train_a_chunk_per_step():
    """The size-aware schedule's groups, each chunked: fewer training
    forwards than clients x steps. Held against the JAX run only: the
    schedule depends on the chunk size (a client trains as many steps as
    its chunk's largest member, and a masked step still applies momentum
    and weight decay), so chunk 1 is another run."""
    jres, pres, _, batched, single = _three_runs(client_chunk_size=4)
    _assert_f32_close(pres, jres)
    assert 0 < batched["train"] < single["train"]


def test_fed_bf16_local_state_batched():
    jres, pres, ores, _, _ = _three_runs(client_chunk_size=3,
                                         local_compute_dtype="bfloat16")
    np.testing.assert_allclose(losses_of(pres), losses_of(jres), rtol=2e-3)
    np.testing.assert_allclose(losses_of(pres), losses_of(ores), rtol=2e-3)


def test_fed_quant_client_eval_batched():
    """fed_quant at 6 clients: client_eval on, so the materializing path,
    in chunks of 4 (a remainder chunk of 2): one vmapped training step and
    one vmapped client eval per chunk."""
    jres, pres, ores, batched, single = _three_runs(
        distributed_algorithm="fed_quant", quant_levels=256, round=1,
        client_chunk_size=4)
    names, numels = _names_and_numels()
    seg = Segments(numels)
    for other in (jres, ores):
        want = flat_params(other, names)
        got = flat_params(pres, names)
        level = seg.spread(stochastic_quantize(want, 256, [0] * len(numels),
                                               seg).scale)
        diff = (got - want).abs()
        assert (diff <= 3 * level).all()
        assert (diff / level).mean().item() < 0.5
        np.testing.assert_allclose(losses_of(pres), losses_of(other),
                                   rtol=5e-3)
        got_ce = pres["history"][0]["client_eval"]
        for k, v in other["history"][0]["client_eval"].items():
            assert abs(got_ce[k] - v) <= 1 / N_EVAL, k
    assert batched["train"] == 2 * 4 and single["train"] == 6 * 4
    # The global eval (2 batches) and one client eval per chunk (2 each).
    assert batched["eval"] == 2 + 2 * 2
    assert single["eval"] == 2 + 6 * 2


def test_sign_sgd_batched():
    """Each step, one vmapped gradient per chunk at the shared params."""
    jres, pres, ores, batched, single = _three_runs(
        distributed_algorithm="sign_SGD", learning_rate=0.001,
        client_chunk_size=4)
    np.testing.assert_allclose(losses_of(pres), losses_of(jres), rtol=1e-4)
    np.testing.assert_allclose(losses_of(pres), losses_of(ores), rtol=1e-4)
    assert batched["train"] == 2 * 4 * 2  # 2 rounds x 4 steps x 2 chunks
    assert single["train"] == 2 * 4 * 6


def _utilities(root):
    (path,) = glob.glob(str(root / "**" / "metric_0.pkl"), recursive=True)
    with open(path, "rb") as f:
        return pickle.load(f)


def test_multiround_shapley_subset_chunks(tmp_path):
    """16 subset models a round evaluated 4 per vmapped forward (each of
    the 2 eval batches), against the JAX evaluator at the same chunk and
    the port's at one model per forward."""
    changes = dict(distributed_algorithm="multiround_shapley_value",
                   worker_number=4, round=1, shapley_eval_dtype="float32",
                   shapley_eval_chunk=4, learning_rate=0.1, epoch=2)
    with _forwards() as chunked:
        _, pres = run_both(log_root=tmp_path, **changes)
    one = dict(BASE, **dict(changes, shapley_eval_chunk=1),
               log_root=str(tmp_path / "one"))
    with _forwards() as single:
        simulator.run_simulation(ExperimentConfig(device="cpu", **one))
    want = _utilities(tmp_path / "jax")
    got = _utilities(tmp_path / "port")
    alone = _utilities(tmp_path / "one")
    assert set(got) == set(want) == set(alone) and len(got) == 16
    for subset, u in got.items():
        assert abs(u - want[subset]) <= 2 / N_EVAL, subset
        assert abs(u - alone[subset]) <= 1 / N_EVAL, subset
    # The round's global eval (2 batches) plus the subsets' forwards.
    assert chunked["eval"] == 2 + (16 // 4) * 2
    assert single["eval"] == 2 + 16 * 2
    assert pres["history"][0]["shapley_values"]
