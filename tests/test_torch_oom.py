"""The port's sized memory refusals and OOM hints against the JAX
package's: the same configuration and the same parameter count give the
same text, numbers included (compared as exact strings).

* ``_assert_client_stack_feasible``: a stack given by its parameter count
  only (nothing large is allocated), for GTG's cumsum walk (3 stacks) and
  for the plain stack;
* ``_assert_residency_feasible``: both branches, at budgets set equal in
  both packages;
* ``_SubsetEvaluator._reraise_oom``: an injected ``torch.OutOfMemoryError``
  in the evaluator and in the cumsum prefix walker (whose floor is one
  prefix block), against the JAX hint for an injected RESOURCE_EXHAUSTED;
  other errors pass through;
* ``_oom_hint``: an injected OOM at a round dispatch, at the server eval and
  at the metric fetch of a run, each re-raised with the JAX text and
  chained from the OOM; once the caller drops it, the run's objects are
  freed by reference counting alone (no cycle holds them until a garbage
  collection: on the card, its device memory).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_learning_simulator_tpu.simulator as jsim
from distributed_learning_simulator_tpu.algorithms.shapley import (
    _CumsumPrefixWalker as JaxWalker,
)
from distributed_learning_simulator_tpu.algorithms.shapley import (
    _SubsetEvaluator as JaxEvaluator,
)
from distributed_learning_simulator_tpu_torch import simulator as psim
from distributed_learning_simulator_tpu_torch.algorithms.shapley import (
    _CumsumPrefixWalker,
    _SubsetEvaluator,
)
from distributed_learning_simulator_tpu_torch.utils.errors import (
    is_device_oom,
)
from torch_runs import port_config

BUDGET = 20 * 2**30


@pytest.fixture
def same_budget(monkeypatch):
    """Both packages' device budget at one value."""
    monkeypatch.setattr(jsim, "_device_budget_bytes", lambda cfg: BUDGET)
    monkeypatch.setattr(psim, "_device_budget_bytes",
                        lambda cfg, device: BUDGET)


def _text(fn, *args, exc=ValueError):
    with pytest.raises(exc) as err:
        fn(*args)
    return str(err.value)


def _jax_params(n):
    return {"w": jax.ShapeDtypeStruct((n,), jnp.float32)}


@pytest.mark.parametrize("algo,mode", [
    ("GTG_shapley_value", "cumsum"),
    ("GTG_shapley_value", "masked"),
    ("multiround_shapley_value", "cumsum"),
])
def test_stack_feasibility_text_equals_jax(tiny_config, same_budget, algo,
                                           mode):
    jcfg = dataclasses.replace(tiny_config, distributed_algorithm=algo,
                               gtg_prefix_mode=mode)
    pcfg = port_config(jcfg)
    n_params = 26_000_000  # ~104 MB x 1000 clients
    want = _text(jsim._assert_client_stack_feasible, jcfg,
                 _jax_params(n_params), 1000)
    got = _text(psim._assert_client_stack_feasible, pcfg, n_params, 1000,
                torch.device("cpu"))
    assert got == want
    assert "parameter stack" in got
    assert ("cumsum-walk" in got) == (algo == "GTG_shapley_value"
                                      and mode == "cumsum")
    # A small model passes untouched.
    psim._assert_client_stack_feasible(pcfg, 100, 4, torch.device("cpu"))


def test_residency_feasibility_names_the_flag(tiny_config, monkeypatch):
    """Twin of the JAX package's test of the same name: the resident
    refusal names client_residency='streamed', the streamed one the cohort
    footprint (double-buffered, or one upload for a full cohort)."""
    params = {"w": np.zeros((4, 4), np.float32)}
    cpu = torch.device("cpu")
    cfg = dataclasses.replace(tiny_config, worker_number=8,
                              participation_fraction=0.25)
    cfg_s = dataclasses.replace(cfg, client_residency="streamed")
    cfg_full = dataclasses.replace(cfg_s, participation_fraction=1.0)

    def both(budget, jcfg, expect):
        monkeypatch.setattr(jsim, "_device_budget_bytes",
                            lambda c: float(budget))
        monkeypatch.setattr(psim, "_device_budget_bytes",
                            lambda c, d: float(budget))
        pcfg = port_config(jcfg)
        if expect is None:
            jsim._assert_residency_feasible(jcfg, params, 8, 1 << 20)
            psim._assert_residency_feasible(pcfg, 16, 8, 1 << 20, cpu)
            return
        want = _text(jsim._assert_residency_feasible, jcfg, params, 8,
                     1 << 20)
        got = _text(psim._assert_residency_feasible, pcfg, 16, 8, 1 << 20,
                    cpu)
        assert got == want
        assert expect in got

    both(1024, cfg, "client_residency='streamed'")
    both(1024, cfg_s, "cohort footprint")
    both(600_000, cfg_s, None)
    both(600_000, cfg, "client_residency='resident'")
    both(1.5 * (1 << 20), cfg_full, None)
    both(900_000, cfg_full, "full-cohort")
    # Persistent state joins the footprint (momentum sign_SGD).
    both(1024, dataclasses.replace(cfg, distributed_algorithm="sign_SGD",
                                   participation_fraction=1.0,
                                   momentum=0.9), "state buffer")


def _oom(*a, **k):
    raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                 "2.00 GiB")


def _jax_oom(*a, **k):
    raise jax.errors.JaxRuntimeError("RESOURCE_EXHAUSTED: out of memory")


def _batches(n_batches):
    return (torch.zeros((n_batches, 4, 2)),
            torch.zeros((n_batches, 4), dtype=torch.int64),
            torch.ones((n_batches, 4)))


def _jax_batches(n_batches):
    return (np.zeros((n_batches, 4, 2)), np.zeros((n_batches, 4), np.int32),
            np.ones((n_batches, 4)))


@pytest.mark.parametrize("chunk,n_batches,needle", [
    (8, 2, "shapley_eval_chunk (e.g. 2)"),
    (1, 1, "already minimal"),
])
def test_subset_evaluator_oom_hint_equals_jax(chunk, n_batches, needle):
    ev = _SubsetEvaluator(lambda *a: {"accuracy": 0.0}, chunk=chunk)
    ev._accuracies = _oom
    stack = torch.zeros((3, 5))
    masks = np.ones((4, 3), np.float32)
    with pytest.raises(RuntimeError) as err:
        ev(stack, torch.ones(3), masks, torch.zeros(5), _batches(n_batches))
    jev = JaxEvaluator(lambda *a: {"accuracy": 0.0}, chunk=chunk)
    jev._eval_chunk = _jax_oom
    with pytest.raises(RuntimeError) as jerr:
        jev(None, None, masks, None, _jax_batches(n_batches))
    assert str(err.value) == str(jerr.value)
    assert needle in str(err.value)
    assert isinstance(err.value.__cause__, torch.OutOfMemoryError)


def test_subset_evaluator_other_errors_pass_through():
    ev = _SubsetEvaluator(lambda *a: {"accuracy": 0.0}, chunk=8)

    def other(*a, **k):
        raise RuntimeError("INTERNAL: something else")

    ev._accuracies = other
    with pytest.raises(RuntimeError, match="something else"):
        ev(torch.zeros((3, 5)), torch.ones(3), np.ones((4, 3), np.float32),
           torch.zeros(5), _batches(2))


def test_prefix_wave_oom_hint_respects_block_floor():
    """At the default chunk of 16, one prefix block, the hint must not
    suggest a smaller chunk (the same 16-model call would fail again)."""
    n = 20
    ev = _SubsetEvaluator(lambda *a: {"accuracy": 0.0}, chunk=16)
    ev.prefix_wave = _oom
    walker = _CumsumPrefixWalker(ev, torch.zeros((n, 3)), torch.ones(n),
                                 torch.zeros(3), _batches(2), n)
    walker.reset()
    perms = [list(range(n))] * n
    with pytest.raises(RuntimeError) as err:
        walker.eval_block(perms, list(range(n)), 0, 16, {})
    jev = JaxEvaluator(lambda *a: {"accuracy": 0.0}, chunk=16)
    jev._prefix_wave = _jax_oom
    jwalker = JaxWalker(jev, {"w": jnp.zeros((n, 3), jnp.float32)},
                        jnp.ones((n,)), {"w": jnp.zeros((3,))},
                        tuple(jnp.asarray(b) for b in _jax_batches(2)), n)
    jwalker.reset()
    with pytest.raises(RuntimeError) as jerr:
        jwalker.eval_block(perms, list(range(n)), 0, 16, {})
    assert str(err.value) == str(jerr.value)
    assert "already minimal" in str(err.value)


def test_is_device_oom_classifies_cuda_cublas_cudnn():
    assert is_device_oom(torch.OutOfMemoryError("CUDA out of memory"))
    for text in ("CUDA error: out of memory",
                 "CUBLAS_STATUS_ALLOC_FAILED when calling cublasCreate",
                 "cuDNN error: CUDNN_STATUS_ALLOC_FAILED"):
        assert is_device_oom(RuntimeError(text)), text
    assert not is_device_oom(RuntimeError("INTERNAL: something else"))
    assert not is_device_oom(ValueError("out of memory"))


def _jax_hint(jcfg, n_params, n_clients, site):
    with pytest.raises(RuntimeError) as err:
        with jsim._oom_hint(jcfg, _jax_params(n_params), n_clients,
                            site=site):
            _jax_oom()
    return str(err.value)


@pytest.mark.parametrize("site", ["dispatch", "eval", "fetch"])
@pytest.mark.parametrize("chunk", [None, 1])
def test_round_oom_hint_equals_jax(tiny_config, same_budget, monkeypatch,
                                   site, chunk):
    """An OOM injected into a run at a round dispatch, the server eval or
    the metric fetch re-raises with JAX's text for the run's config and
    parameter count: a ``client_chunk_size=`` suggestion (at chunk 1, the
    exceeded-even-at-minimum text), and ``eval_batch_size`` at the eval
    and the deferred metric fetch, under the site names JAX's own run
    passes there (``"eval"``, ``"deferred metric fetch"``)."""
    jcfg = dataclasses.replace(tiny_config, client_chunk_size=chunk)
    pcfg = port_config(jcfg)
    if site == "dispatch":
        make = psim.get_algorithm

        def get_algorithm(name, config):
            algo = make(name, config)
            algo.make_round_fn = lambda *a, **k: _oom
            return algo

        monkeypatch.setattr(psim, "get_algorithm", get_algorithm)
    elif site == "eval":
        monkeypatch.setattr(psim, "make_eval_fn", lambda apply_fn: _oom)
    else:
        # The fetch's wait (pipelined rounds start its copies earlier).
        monkeypatch.setattr(psim, "finish_fetch", _oom)
    n_params = {}
    flatten = psim.ParamLayout.flatten

    def spy(self, params):
        flat = flatten(self, params)
        n_params["n"] = flat.numel()
        return flat

    monkeypatch.setattr(psim.ParamLayout, "flatten", spy)
    with pytest.raises(RuntimeError) as err:
        psim.run_simulation(pcfg, setup_logging=False)
    assert isinstance(err.value.__cause__, torch.OutOfMemoryError)
    jax_site = {"dispatch": "round", "eval": "eval",
                "fetch": "deferred metric fetch"}[site]
    want = _jax_hint(jcfg, n_params["n"], jcfg.worker_number, jax_site)
    assert str(err.value) == want
    assert ("eval_batch_size" in want) == (site != "dispatch")
    assert (f"surfaced at {jax_site}:" in want) == (site != "dispatch")
    assert ("Try client_chunk_size=2" in want) == (chunk is None)


@pytest.mark.parametrize("site", ["dispatch", "eval", "fetch"])
def test_dropped_hint_frees_the_run_without_gc(tiny_config, monkeypatch,
                                               site):
    """Once the caller drops the re-raised hint, the run's objects (its
    model here, its device arrays on the card) are freed by reference
    counting alone: the hint holds no reference cycle with the OOM, which
    would keep every frame of the run alive until a garbage collection."""
    import gc
    import weakref

    refs = []
    get_model = psim.get_model

    def spy(*a, **k):
        model = get_model(*a, **k)
        refs.append(weakref.ref(model))
        return model

    monkeypatch.setattr(psim, "get_model", spy)
    if site == "dispatch":
        make = psim.get_algorithm

        def get_algorithm(name, config):
            algo = make(name, config)
            algo.make_round_fn = lambda *a, **k: _oom
            return algo

        monkeypatch.setattr(psim, "get_algorithm", get_algorithm)
    elif site == "eval":
        monkeypatch.setattr(psim, "make_eval_fn", lambda apply_fn: _oom)
    else:
        # The fetch's wait (pipelined rounds start its copies earlier).
        monkeypatch.setattr(psim, "finish_fetch", _oom)
    gc.disable()
    try:
        with pytest.raises(RuntimeError, match="device memory exceeded"):
            psim.run_simulation(port_config(tiny_config),
                                setup_logging=False)
        assert refs and refs[0]() is None
    finally:
        gc.enable()
