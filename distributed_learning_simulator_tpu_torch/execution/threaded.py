"""Threaded execution mode: the reference's architecture, a thread per
client and a blocking rendezvous queue (execution/threaded.py of the JAX
package).

The fast path trains a chunk of clients as one vmapped program
(parallel/engine.py). This mode keeps the reference's thread/queue design
as a differential oracle for it and as an escape hatch for per-client
logic that cannot be vmapped, over the native C++ runtime
(runtime/native.py).

* :class:`ThreadedServer` owns the rendezvous queue, built with
  ``worker_fun=self._process_worker_data``, and seeds it with the initial
  global model broadcast to every worker. The callback buffers each
  client's upload and, on the Nth arrival, aggregates (in worker-id order,
  by ``config.aggregation``), evaluates, records the round and broadcasts
  the new model. Hooks ``_process_client_parameter`` /
  ``_process_aggregated_parameter`` are overridable.
* :class:`ThreadedWorker` blocks for the global model, runs its local
  epochs with the run's one local-train function, and uploads
  ``(worker_id, dataset_size, params)``.
* :class:`ThreadedSignSGDServer` / :class:`ThreadedSignSGDWorker` sync at
  every optimizer step: each worker submits its sign direction, blocks for
  the majority vote and applies it; the server applies the same vote to
  its own replica (bitwise the workers' params) to evaluate each round.

Port specifics:

* A model is one flat f32 vector (models/registry.py ``ParamLayout``).
  Payloads cross the queue as pickled host numpy arrays (the JAX package
  pickles ``device_get`` trees): a CUDA tensor never goes into a pickle.
* Every thread (the pool's workers and the serve thread) launches on the
  device's default stream, as the JAX oracle shares one device queue, and
  the kernels are deterministic, so two runs are bitwise equal.
* ``torch.func.functional_call`` swaps a module's parameters while it
  runs, so each thread calls its own copy of the model
  (:class:`_ThreadModels`); the local-train and eval functions are built
  once and shared, as the JAX package's jitted ones are.
* Worker w's key is ``key(seed * 100003 + w)`` through ops/prng.py, split
  each round into ``(key, round_key, upload_key)``; its batch orders come
  from ``round_key`` as in the JAX ``local_train``, so a port run and a
  JAX run of this mode train the same batches. sign_SGD workers draw their
  batch orders from ``numpy.random.default_rng(seed * 100003 + w)``, as
  the JAX workers do.
"""

from __future__ import annotations

import copy
import json
import os
import pickle
import threading
import time
from typing import Any

import numpy as np
import torch

from distributed_learning_simulator_tpu_torch.config import ExperimentConfig
from distributed_learning_simulator_tpu_torch.data.partition import ClientData
from distributed_learning_simulator_tpu_torch.data.registry import (
    Dataset,
    get_dataset,
)
from distributed_learning_simulator_tpu_torch.models.bridge import (
    jax_leaf_order,
)
from distributed_learning_simulator_tpu_torch.models.registry import (
    ParamLayout,
    get_model,
    init_params,
)
from distributed_learning_simulator_tpu_torch.ops import prng
from distributed_learning_simulator_tpu_torch.ops.aggregate import aggregate
from distributed_learning_simulator_tpu_torch.ops.augment import get_augment
from distributed_learning_simulator_tpu_torch.ops.payload import (
    compression_ratio,
    payload_bytes,
    quantized_payload_bytes,
    sign_payload_bytes,
)
from distributed_learning_simulator_tpu_torch.ops.quantize import (
    QuantizedTensor,
    Segments,
    dequantize,
    fake_quant,
    stochastic_quantize,
)
from distributed_learning_simulator_tpu_torch.parallel.engine import (
    client_draws,
    make_decoder,
    make_eval_fn,
    make_local_train_fn,
    make_optimizer,
    pad_eval_set,
)
from distributed_learning_simulator_tpu_torch.robustness.faults import (
    all_finite,
)
from distributed_learning_simulator_tpu_torch.runtime.native import (
    NativeTaskQueue,
    NativeThreadPool,
)
from distributed_learning_simulator_tpu_torch.telemetry import (
    ClientStats,
    RecompileMonitor,
    detect_and_record,
    make_phase_timer,
    peak_hbm_bytes,
    tracked,
)
from distributed_learning_simulator_tpu_torch.utils.logging import get_logger
from distributed_learning_simulator_tpu_torch.utils.reporting import (
    build_round_record,
)


class _ThreadModels(threading.local):
    """Each thread's own copy of the model, made at its first use:
    ``functional_call`` reparametrizes the module it is given in place."""

    def __init__(self, model):
        self.model = copy.deepcopy(model)


def _to_host(q: QuantizedTensor) -> QuantizedTensor:
    return QuantizedTensor(*(t.cpu().numpy() for t in q))


def _to_device(q: QuantizedTensor, device) -> QuantizedTensor:
    return QuantizedTensor(*(torch.as_tensor(a, device=device) for a in q))


class _QueueServerBase:
    """The threaded servers' rendezvous plumbing.

    Each worker has its own downlink queue (the reference broadcasts N
    copies into one shared pool, where a fast worker can take a slow
    peer's copy and deadlock the barrier); the shared uplink queue and its
    ``worker_fun`` callback are the reference's."""

    worker_number: int

    def _init_queues(self) -> None:
        self.server_error: BaseException | None = None
        # Run telemetry: the serve thread times its aggregate / eval /
        # post_round work per round (local training runs on the workers).
        self._phase_timer = make_phase_timer(self.config.telemetry_level)
        # Per-client statistics off the upload stack the barrier holds;
        # the workers report no losses, so those columns are NaN.
        self._client_stats = ClientStats.from_config(self.config)
        self.clients_flagged = 0
        self.result_queues = [
            NativeTaskQueue() for _ in range(self.worker_number)
        ]
        self.worker_data_queue = NativeTaskQueue(
            worker_fun=self._guarded_worker_fun
        )

    def _finish_record(self, record: dict, round_idx: int,
                       client_stats: dict | None = None) -> dict:
        """The round's telemetry and client stats folded into the record
        by the shared builder; with both off the v1 record is unchanged."""
        tel = None
        if self._phase_timer.enabled:
            tel = {
                "phase_seconds": {
                    k: round(v, 6)
                    for k, v in sorted(
                        self._phase_timer.take(round_idx).items()
                    )
                },
            }
            peak = peak_hbm_bytes(self.device)
            if peak is not None:
                tel["peak_hbm_bytes"] = peak
        if tel is None and client_stats is None:
            return record
        return build_round_record(record, tel, client_stats)

    def _guarded_worker_fun(self, data, extra_args):
        """A callback error tears the rendezvous down: it is recorded, every
        queue stops (blocked workers get 'queue is stopped'), and the
        coordinator re-raises the original error."""
        try:
            return self._process_worker_data(data, extra_args)
        except BaseException as e:  # noqa: BLE001 - re-raised by coordinator
            self.server_error = e
            self.stop()
            return None

    def _process_worker_data(self, data, extra_args):  # pragma: no cover
        raise NotImplementedError

    def _broadcast(self, payload) -> None:
        # Pickled once, enqueued on every worker's downlink.
        blob = pickle.dumps(payload)
        for q in self.result_queues:
            try:
                q.put_result_pickled(blob)
            except RuntimeError:
                # Only the stopped-queue race is benign.
                if not q.stopped:
                    raise

    def _write(self, record: dict) -> None:
        self.history.append(record)
        if self.metrics_path:
            with open(self.metrics_path, "a") as f:
                f.write(json.dumps(record) + "\n")

    def stop(self):
        self.worker_data_queue.stop()
        for q in self.result_queues:
            q.stop()


class ThreadedServer(_QueueServerBase):
    """The queue-owning FedAvg server. ``evaluate(flat, *eval_batches)``
    evaluates a flat model; ``init_params`` is the flat f32 initial model
    on ``device``."""

    def __init__(self, config: ExperimentConfig, evaluate, eval_batches,
                 init_params, layout, metrics_path: str | None = None):
        self.config = config
        self.worker_number = config.worker_number
        self._evaluate = evaluate
        self._eval_batches = eval_batches
        self.layout = layout
        self.device = init_params.device
        self._buffer: dict[int, tuple[float, torch.Tensor]] = {}
        self._round = 0
        self.history: list[dict] = []
        self.metrics_path = metrics_path
        self.prev_model = init_params
        self._round_t0 = time.perf_counter()
        self._init_queues()
        self._broadcast(init_params.cpu().numpy())

    # Template hooks.
    def _process_client_parameter(self, worker_id: int, params):
        return torch.as_tensor(params, device=self.device)

    def _process_aggregated_parameter(self, params):
        return params

    def _record_extra(self, aggregated) -> dict:
        """Algorithm-specific per-round record fields."""
        del aggregated
        return {}

    def _post_round(self, stacked, sizes, aggregated, metrics) -> dict:
        """Server-side post-round hook with the whole upload stack (the
        Shapley servers score here); returns extra record fields."""
        del stacked, sizes, aggregated, metrics
        return {}

    def _process_worker_data(self, data, extra_args):
        del extra_args
        worker_id, dataset_size, params = data
        self._buffer[worker_id] = (
            dataset_size, self._process_client_parameter(worker_id, params)
        )
        if len(self._buffer) < self.worker_number:
            return None  # the barrier: wait for every client
        with self._phase_timer.phase(self._round, "aggregate") as _ph:
            stacked = torch.stack(
                [self._buffer[i][1] for i in range(self.worker_number)])
            sizes = np.asarray(
                [self._buffer[i][0] for i in range(self.worker_number)],
                dtype=np.float32,
            )
            aggregated = aggregate(
                stacked, sizes, self.config.aggregation,
                self.config.trim_ratio,
            )
            if (self.config.aggregation.lower() != "mean"
                    and not all_finite(aggregated)):
                # The vmap path's guard: an all-diverged cohort keeps the
                # previous global model.
                aggregated = self.prev_model
            cs_rec = None
            if (
                self._client_stats is not None
                and self._client_stats.fetch_round(self._round)
            ):
                # On the raw aggregate, as the vmap path's probe.
                cs_rec, n_flagged = detect_and_record(
                    self._client_stats.stack_stats(
                        self.prev_model, stacked, aggregated,
                        self.layout.numels,
                    ).cpu().numpy(),
                    self._client_stats, self._round, logger=get_logger(),
                )
                self.clients_flagged += n_flagged
            aggregated = self._process_aggregated_parameter(aggregated)
            _ph.fence(aggregated)
        with self._phase_timer.phase(self._round, "eval"):
            # float() waits for the device values.
            metrics = {
                k: float(v)
                for k, v in self._evaluate(
                    aggregated, *self._eval_batches
                ).items()
            }
        with self._phase_timer.phase(self._round, "post_round"):
            extra_post = self._post_round(stacked, sizes, aggregated, metrics)
        record = {
            "round": self._round,
            "test_accuracy": metrics["accuracy"],
            "test_loss": metrics["loss"],
            "round_seconds": time.perf_counter() - self._round_t0,
            **self._record_extra(aggregated),
            **extra_post,
        }
        self._write(self._finish_record(record, self._round,
                                        client_stats=cs_rec))
        get_logger().info(
            "threaded round %d: test_acc=%.4f test_loss=%.4f",
            self._round, metrics["accuracy"], metrics["loss"],
        )
        self.prev_model = aggregated
        self._round += 1
        self._round_t0 = time.perf_counter()
        self._buffer.clear()
        self._broadcast(aggregated.cpu().numpy())
        return None


class ThreadedWorker:
    """One simulated client on its own thread. ``local_train(params,
    opt_state, xs, ys, mask, key)`` is the run's shared local-train
    function; ``shard`` is ``(xs, ys, mask, size)`` on the device."""

    def __init__(self, worker_id: int, queue: NativeTaskQueue,
                 result_queue: NativeTaskQueue, local_train, shard,
                 rounds: int, seed: int):
        self.worker_id = worker_id
        self.queue = queue
        self.result_queue = result_queue
        self._local_train = local_train
        self._shard = shard
        self._rounds = rounds
        self._seed = seed

    def train(self):
        xs, ys, mask, size = self._shard
        key = prng.key(self._seed * 100003 + self.worker_id)
        for _ in range(self._rounds):
            # Block for the current global model.
            params = torch.as_tensor(self.result_queue.get_result(),
                                     device=xs.device)
            key, round_key, upload_key = prng.split(key, 3)
            new_params, _, _ = self._local_train(
                params, None, xs, ys, mask, round_key
            )
            # Upload (worker_id, |D_i|, params) as host arrays.
            self.queue.add_task((
                self.worker_id, size,
                self._upload_payload(new_params, upload_key),
            ))

    def _upload_payload(self, new_params, key):
        """Uplink transform hook (the flat params; FedQuant quantizes)."""
        del key
        return new_params.cpu().numpy()


class ThreadedFedQuantServer(ThreadedServer):
    """Quantized-exchange FedAvg through the queue: each upload is a
    quantized tree, dequantized before the weighted mean; the aggregate is
    re-quantized for the downlink (the broadcast carries the dequantized
    values) with keys from ``key(seed + 9973)``, one split a round; the
    record reports the compression ratios. The math is ops/quantize.py's,
    shared with the vmap FedQuant, with the scale divided as the JAX
    oracle's un-jitted quantization divides it (``eager``)."""

    def __init__(self, config: ExperimentConfig, evaluate, eval_batches,
                 init_params, layout, metrics_path: str | None = None):
        self._levels = getattr(config, "quant_levels", 256)
        self._quant_key = prng.key(config.seed + 9973)
        self._segments = Segments(layout.numels, init_params.device)
        super().__init__(config, evaluate, eval_batches, init_params, layout,
                         metrics_path=metrics_path)

    def _process_client_parameter(self, worker_id: int, params):
        del worker_id
        return dequantize(_to_device(params, self.device), self._segments)

    def _process_aggregated_parameter(self, params):
        self._quant_key, k = prng.split(self._quant_key)
        salts = prng.leaf_salts(k, len(self.layout.numels))
        return dequantize(
            stochastic_quantize(params, self._levels, salts, self._segments,
                                eager=True),
            self._segments,
        )

    def _record_extra(self, aggregated) -> dict:
        del aggregated
        raw = payload_bytes(self.layout)
        comp = quantized_payload_bytes(self.layout, self._levels)
        ratio = compression_ratio(raw, comp)
        return {
            "uplink_compression_ratio": ratio,
            "downlink_compression_ratio": ratio,
        }


class ThreadedFedQuantWorker(ThreadedWorker):
    """FedQuant client thread: QAT local training (the shared local-train
    function carries the fake-quant transform), then a stochastically
    quantized upload (codes, scales and zero points as host arrays)."""

    def __init__(self, *args, levels: int = 256, segments=None):
        super().__init__(*args)
        self._levels = levels
        self._segments = segments

    def _upload_payload(self, new_params, key):
        salts = prng.leaf_salts(key, len(self._segments.numels))
        return _to_host(stochastic_quantize(new_params, self._levels, salts,
                                            self._segments, eager=True))


class ThreadedShapleyServer(ThreadedServer):
    """Shapley scoring through the queue: the post-round hook scores each
    client from the whole upload stack with the vmap path's own strategy
    object (algorithms/shapley.py) and its subset evaluator."""

    def __init__(self, config: ExperimentConfig, evaluate, eval_batches,
                 init_params, layout, algorithm, log_dir: str | None = None,
                 metrics_path: str | None = None):
        self._shapley = algorithm
        self._prev_metrics: dict | None = None
        self._log_dir = log_dir
        super().__init__(config, evaluate, eval_batches, init_params, layout,
                         metrics_path=metrics_path)

    def _post_round(self, stacked, sizes, aggregated, metrics) -> dict:
        from distributed_learning_simulator_tpu_torch.algorithms.base import (
            RoundContext,
        )

        ctx = RoundContext(
            round_idx=self._round,
            global_params=aggregated,
            # prev_model still holds the round's broadcast source: the
            # empty coalition's model.
            prev_global_params=self.prev_model,
            sizes=sizes,
            aux={"client_params": stacked},
            metrics=metrics,
            prev_metrics=self._prev_metrics,
            eval_batches=self._eval_batches,
            log_dir=self._log_dir,
            layout=self.layout,
        )
        extra = self._shapley.post_round(ctx) or {}
        self._prev_metrics = metrics
        return {
            k: v for k, v in extra.items()
            if isinstance(v, (int, float, dict))
        }


class ThreadedSignSGDServer(_QueueServerBase):
    """The per-step majority-vote server: buffers each worker's signs; on
    the Nth arrival sums them and re-signs, broadcasts the vote, and
    applies it to its own replica (every worker applies the same vote with
    the same function, so the replicas stay bitwise equal). Every
    ``steps_per_round`` votes it evaluates the replica and records the
    round."""

    def __init__(self, config: ExperimentConfig, evaluate, eval_batches,
                 init_params, layout, apply_vote, steps_per_round: int,
                 metrics_path: str | None = None):
        self.config = config
        self.worker_number = config.worker_number
        self._evaluate = evaluate
        self._eval_batches = eval_batches
        self.layout = layout
        self.device = init_params.device
        self._apply_vote = apply_vote
        self._steps_per_round = steps_per_round
        self._buffer: dict[int, Any] = {}
        self._step = 0
        self.history: list[dict] = []
        self.metrics_path = metrics_path
        self.params = init_params
        self._round_t0 = time.perf_counter()
        self._init_queues()
        # No initial broadcast: the workers start from the same init.

    def _process_worker_data(self, data, extra_args):
        del extra_args
        worker_id, signs = data
        self._buffer[worker_id] = signs
        if len(self._buffer) < self.worker_number:
            return None  # the barrier: every step waits for all N workers
        # Each step's vote lands in its round's 'aggregate' phase.
        with self._phase_timer.phase(
                self._step // self._steps_per_round, "aggregate") as _ph:
            voted = np.sign(np.sum(np.stack(
                [self._buffer[i] for i in range(self.worker_number)]),
                axis=0))
            self._buffer.clear()
            self.params = self._apply_vote(
                self.params, torch.as_tensor(voted, device=self.device))
            _ph.fence(self.params)
        self._step += 1
        if self._step % self._steps_per_round == 0:
            round_idx = self._step // self._steps_per_round - 1
            with self._phase_timer.phase(round_idx, "eval"):
                metrics = {
                    k: float(v)
                    for k, v in self._evaluate(
                        self.params, *self._eval_batches
                    ).items()
                }
            record = {
                "round": round_idx,
                "test_accuracy": metrics["accuracy"],
                "test_loss": metrics["loss"],
                "round_seconds": time.perf_counter() - self._round_t0,
                "uplink_compression_ratio": compression_ratio(
                    payload_bytes(self.layout),
                    sign_payload_bytes(self.layout),
                ),
                "sync_steps": self._steps_per_round,
            }
            self._write(self._finish_record(record, round_idx))
            get_logger().info(
                "threaded round %d: test_acc=%.4f test_loss=%.4f",
                round_idx, metrics["accuracy"], metrics["loss"],
            )
            self._round_t0 = time.perf_counter()
        self._broadcast(voted)
        return None


class ThreadedSignSGDWorker:
    """One SignSGD client on its own thread: per optimizer step, the
    torch-SGD direction (momentum, the first step's buffer = grad), its
    sign submitted, the vote awaited and applied."""

    def __init__(self, worker_id: int, queue: NativeTaskQueue,
                 result_queue: NativeTaskQueue, direction_fn,
                 apply_vote, shard, init_params, rounds: int,
                 epochs: int, batch_size: int, seed: int):
        self.worker_id = worker_id
        self.queue = queue
        self.result_queue = result_queue
        self._direction = direction_fn
        self._apply_vote = apply_vote
        self._shard = shard
        self._init_params = init_params
        self._rounds = rounds
        self._epochs = epochs
        self._batch_size = batch_size
        self._seed = seed

    def train(self):
        xs, ys, mask, _size = self._shard
        params = self._init_params.clone()
        momenta = torch.zeros_like(params)
        shard_size = xs.shape[0]
        steps_per_epoch = shard_size // self._batch_size
        rng = np.random.default_rng(self._seed * 100003 + self.worker_id)
        is_first = True
        for _ in range(self._rounds):
            for _ in range(self._epochs):
                perm = rng.permutation(shard_size)
                for s in range(steps_per_epoch):
                    idx = torch.as_tensor(
                        perm[s * self._batch_size:(s + 1) * self._batch_size],
                        device=xs.device)
                    signs, momenta = self._direction(
                        params, momenta, is_first, xs[idx], ys[idx],
                        mask[idx],
                    )
                    is_first = False
                    self.queue.add_task(
                        (self.worker_id, signs.cpu().numpy()))
                    voted = self.result_queue.get_result()
                    params = self._apply_vote(
                        params, torch.as_tensor(voted, device=xs.device))


def run_threaded_simulation(
    config: ExperimentConfig,
    dataset: Dataset | None = None,
    client_data: ClientData | None = None,
    setup_logging: bool = True,
):
    """Run an algorithm in thread-per-client mode; returns a result dict
    (the JAX package's keys plus ``device``).

    The same algorithm as ``run_simulation``, trained client by client on
    threads: a differential oracle for the vmap path (batch orders differ,
    so trajectories agree statistically, not bitwise).
    """
    from distributed_learning_simulator_tpu_torch.simulator import (
        build_client_data,
        resolve_device,
    )

    config.validate()
    algo_name = config.distributed_algorithm
    supported = ("fed", "sign_SGD", "fed_quant", "multiround_shapley_value",
                 "GTG_shapley_value")
    if algo_name not in supported:
        raise ValueError(
            f"threaded execution mode supports {supported}, not "
            f"{algo_name!r}"
        )
    if algo_name == "sign_SGD":
        # The constructor runs sign_SGD's config checks (SGD, no
        # augmentation, mean aggregation), shared with the vmap path.
        from distributed_learning_simulator_tpu_torch.algorithms.sign_sgd import (  # noqa: E501
            SignSGD,
        )

        SignSGD(config)
    if algo_name == "multiround_shapley_value":
        # The exact-Shapley N <= 16 bound, before any thread starts.
        from distributed_learning_simulator_tpu_torch.algorithms.shapley import (  # noqa: E501
            MultiRoundShapley,
        )

        MultiRoundShapley(config)
    if config.server_optimizer_name.lower() not in ("none", ""):
        raise ValueError(
            "threaded execution mode does not support server optimizers; "
            "use run_simulation for FedAvgM/FedAdam"
        )
    if config.participation_fraction < 1.0:
        raise ValueError(
            "threaded execution mode trains all clients every round; "
            "participation_fraction < 1 requires the vmap execution mode"
        )
    if (config.checkpoint_dir and config.checkpoint_every) or config.resume:
        raise ValueError(
            "threaded execution mode does not support checkpoint/resume; "
            "use the vmap execution mode"
        )
    if config.local_compute_dtype != "float32":
        raise ValueError(
            "threaded execution mode does not support local_compute_dtype="
            f"{config.local_compute_dtype!r}; use the vmap execution mode"
        )
    if config.lr_schedule.lower() != "constant":
        raise ValueError(
            "threaded execution mode does not support lr_schedule="
            f"{config.lr_schedule!r}; use the vmap execution mode"
        )
    if config.client_eval is True:
        raise ValueError(
            "threaded execution mode does not support client_eval=True; "
            "use the vmap execution mode"
        )
    if getattr(config, "async_mode", "off").lower() == "on":
        raise ValueError(
            "threaded execution mode does not support async_mode='on'; "
            "use the vmap execution mode"
        )
    if (
        config.client_eval is None
        and algo_name == "fed_quant"
        and config.cohort_size() <= 32
    ):
        get_logger().info(
            "threaded mode does not produce client_eval telemetry (the "
            "vmap execution mode auto-enables it for fed_quant at cohort "
            "size %d)", config.cohort_size(),
        )
    if config.multihost:
        raise ValueError(
            "execution_mode='threaded' does not support multihost; "
            "use the vmap execution mode"
        )
    from distributed_learning_simulator_tpu_torch.utils.logging import (
        set_level,
        set_run_artifacts,
    )

    device = resolve_device(config.device)
    set_level(config.log_level)
    metrics_path = None
    log_dir = None
    if setup_logging:
        # The vmap path's artifacts: a log file under
        # log/<algo>/<dataset>/<model>/ and metrics.jsonl beside it.
        log_path, log_dir = set_run_artifacts(
            config.log_root, config.distributed_algorithm,
            config.dataset_name, config.model_name,
        )
        metrics_path = os.path.join(log_dir, "metrics.jsonl")
        get_logger().info("log file: %s", log_path)
    if dataset is None:
        dataset = get_dataset(
            config.dataset_name, data_dir=config.data_dir, seed=config.seed,
            n_train=config.n_train, n_test=config.n_test,
            **config.dataset_args,
        )
    if client_data is None:
        client_data = build_client_data(config, dataset)

    sample_shape = dataset.x_train.shape[1:]
    model = get_model(
        config.model_name, num_classes=dataset.num_classes,
        input_shape=sample_shape, **config.model_args,
    ).to(device)
    params_tree = init_params(model, sample_shape[:2], seed=config.seed)
    layout = ParamLayout.from_params(
        params_tree, jax_leaf_order(model, sample_shape[:2])
    )
    params = layout.flatten(params_tree).to(device)
    models = _ThreadModels(model)

    def apply_fn(flat_views, x):
        return torch.func.functional_call(models.model, flat_views, (x,))

    optimizer = make_optimizer(
        config.optimizer_name, config.learning_rate,
        momentum=config.momentum, weight_decay=config.weight_decay,
    )
    decoder = (
        make_decoder(client_data.sample_shape) if client_data.compact else None
    )
    evaluate_tree = make_eval_fn(apply_fn)
    evaluate = tracked(
        "evaluate",
        lambda flat, *batches: evaluate_tree(layout.unflatten(flat),
                                             *batches))
    xb, yb, mb = pad_eval_set(
        dataset.x_test, dataset.y_test, config.eval_batch_size
    )
    eval_batches = (
        torch.as_tensor(xb, device=device),
        torch.as_tensor(yb, dtype=torch.int64, device=device),
        torch.as_tensor(mb, device=device),
    )

    # Run-scoped recompile counter: the workers share one local-train
    # function, so a healthy run counts each program once in all; threads
    # run concurrently, so the count is reported once at the end.
    recompile = (
        RecompileMonitor().start()
        if config.telemetry_level.lower() != "off" else None
    )
    t_start = time.perf_counter()
    if algo_name == "sign_SGD":
        server, make_worker = _build_sign_sgd(
            config, apply_fn, layout, params, evaluate, eval_batches,
            decoder, client_data, metrics_path,
        )
    else:
        param_transform = None
        segments = Segments(layout.numels, device)
        if algo_name == "fed_quant" and getattr(config, "qat", True):
            # QAT: the vmap FedQuant's straight-through fake-quant.
            levels = getattr(config, "quant_levels", 256)

            def param_transform(flat):
                return fake_quant(flat, levels, segments)

        augment = get_augment(config.augment)
        train_one = make_local_train_fn(
            apply_fn, optimizer, layout, local_epochs=config.epoch,
            batch_size=config.batch_size, reset_optimizer=True,
            preprocess=decoder, augment=augment,
            param_transform=param_transform,
        )

        def local_train(params, opt_state, xs, ys, mask, key):
            """The JAX ``local_train(params, opt_state, xs, ys, mask,
            key)``: the client's batch orders (and augmentation key) from
            ``key``, then its local run."""
            draws = client_draws(key, xs.shape[0], config.epoch,
                                 augment=augment is not None)
            return train_one(params, xs, ys, mask, *draws,
                             opt_state=opt_state)

        if algo_name == "fed_quant":
            server = ThreadedFedQuantServer(
                config, evaluate, eval_batches, params, layout,
                metrics_path=metrics_path)
            q_levels = getattr(config, "quant_levels", 256)

            def make_worker(worker_id, shard):
                return ThreadedFedQuantWorker(
                    worker_id, server.worker_data_queue,
                    server.result_queues[worker_id], local_train, shard,
                    config.round, config.seed, levels=q_levels,
                    segments=segments,
                )
        elif algo_name in ("multiround_shapley_value", "GTG_shapley_value"):
            # FedAvg workers; the server scores with the vmap path's
            # strategy object.
            from distributed_learning_simulator_tpu_torch.factory import (
                get_algorithm,
            )

            shapley = get_algorithm(algo_name, config)
            # Count-dependent feasibility against the true client count,
            # before any thread starts.
            shapley.check_cohort(client_data.n_clients)
            shapley.bind_layout(layout)
            shapley.prepare(apply_fn, evaluate_tree, eval_batches)
            server = ThreadedShapleyServer(
                config, evaluate, eval_batches, params, layout, shapley,
                log_dir=log_dir, metrics_path=metrics_path,
            )

            def make_worker(worker_id, shard):
                return ThreadedWorker(
                    worker_id, server.worker_data_queue,
                    server.result_queues[worker_id], local_train, shard,
                    config.round, config.seed,
                )
        else:
            server = ThreadedServer(config, evaluate, eval_batches, params,
                                    layout, metrics_path=metrics_path)

            def make_worker(worker_id, shard):
                return ThreadedWorker(
                    worker_id, server.worker_data_queue,
                    server.result_queues[worker_id], local_train, shard,
                    config.round, config.seed,
                )

    pool = NativeThreadPool(config.worker_number)
    try:
        for worker_id in range(client_data.n_clients):
            shard = (
                torch.as_tensor(client_data.x[worker_id], device=device),
                torch.as_tensor(client_data.y[worker_id], dtype=torch.int64,
                                device=device),
                torch.as_tensor(client_data.mask[worker_id], device=device),
                float(client_data.sizes[worker_id]),
            )
            pool.exec(make_worker(worker_id, shard).train)
        # An error-aware wait: on the first worker error the queues stop
        # (its blocked peers unblock with 'queue is stopped') before the
        # join; pool.results() re-raises the original error.
        while True:
            done, submitted, failed = pool.poll()
            if failed or done == submitted:
                break
            time.sleep(0.02)
        if failed:
            server.stop()
        pool.join_pending()
        if server.server_error is not None:
            # The root cause of a torn-down rendezvous.
            raise server.server_error
        pool.results()  # re-raise any worker error
    finally:
        # The server first: workers blocked in get_result unblock only
        # once the queues stop.
        server.stop()
        pool.stop()
        if recompile is not None:
            recompile.stop()
    if server.server_error is not None:
        # The last round's callback runs after every worker has exited and
        # surfaces only once stop() has joined the serve thread.
        raise server.server_error
    total = time.perf_counter() - t_start
    xla_compiles = None
    if recompile is not None:
        events = recompile.drain()
        xla_compiles = len(events)
        get_logger().info(
            "threaded run: %d compile(s) total: %s",
            xla_compiles,
            ", ".join(sorted({name for name, _ in events})) or "-",
        )
    history = server.history
    n = client_data.n_clients
    final_params = (
        server.params if algo_name == "sign_SGD" else server.prev_model
    )
    return {
        "global_params": layout.unflatten(final_params),
        "history": history,
        "final_accuracy": history[-1]["test_accuracy"] if history else None,
        "total_seconds": total,
        "client_rounds_per_sec": config.round * n / max(total, 1e-9),
        "telemetry_level": config.telemetry_level.lower(),
        "xla_compiles": xla_compiles,
        # The detector's flags over the run, None with client stats off
        # (the sign_SGD server computes no per-client stats: 0).
        "clients_flagged": (
            getattr(server, "clients_flagged", 0)
            if ClientStats.from_config(config) is not None else None
        ),
        "device": str(device),
    }


def _build_sign_sgd(config, apply_fn, layout, params, evaluate, eval_batches,
                    decoder, client_data, metrics_path):
    """The per-step sign-vote mode's step functions, server and worker
    factory. The step math is ops/sign.py's, shared with the vmap SignSGD;
    server and workers apply votes with the same function, so their
    replicas stay bitwise equal."""
    from distributed_learning_simulator_tpu_torch.ops.sign import (
        direction_leaf,
        momentum_leaf,
        sign_compress,
        vote_apply_leaf,
    )
    from distributed_learning_simulator_tpu_torch.parallel.engine import (
        make_loss_fn,
    )

    lr = config.learning_rate
    mu = config.momentum
    dampening = config.dampening
    nesterov = config.nesterov
    wd = config.weight_decay
    loss_fn = make_loss_fn(
        lambda flat, x: apply_fn(layout.unflatten(flat), x))
    grad_fn = torch.func.grad_and_value(loss_fn, has_aux=True)

    def direction_fn(p, momenta, is_first, bx, by, bm):
        if decoder is not None:
            bx = decoder(bx)
        grads, _ = grad_fn(p, bx, by, bm)
        with torch.no_grad():
            first = torch.tensor(is_first, device=grads.device)
            momenta_new = momentum_leaf(momenta, grads, first, mu, dampening)
            direction = direction_leaf(grads, momenta_new, mu, nesterov)
            return sign_compress(direction), momenta_new

    def apply_vote(p, voted):
        with torch.no_grad():
            return vote_apply_leaf(p, voted, lr, wd)

    direction_fn = tracked("direction_fn", direction_fn)
    apply_vote = tracked("apply_vote", apply_vote)
    shard_size = client_data.x.shape[1]
    steps_per_round = config.epoch * (shard_size // config.batch_size)
    server = ThreadedSignSGDServer(
        config, evaluate, eval_batches, params, layout, apply_vote,
        steps_per_round, metrics_path=metrics_path,
    )

    def make_worker(worker_id, shard):
        return ThreadedSignSGDWorker(
            worker_id, server.worker_data_queue,
            server.result_queues[worker_id], direction_fn, apply_vote,
            shard, params, config.round, config.epoch, config.batch_size,
            config.seed,
        )

    return server, make_worker
