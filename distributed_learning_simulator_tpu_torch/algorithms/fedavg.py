"""FedAvg: dataset-size-weighted federated averaging (algorithms/fedavg.py of
the JAX package).

One round: the cohort trains from the global model, and the server combines
the uploads. The round takes the round key of the JAX package's key chain
and derives every draw from it as the JAX program does (ops/prng.py):
``round_key_splits`` gives ``(part_key, train_key, payload_key, agg_key)``,
and with a failure model a fifth, the failure draws' key;
the cohort comes from ``part_key`` (ops/sampling.py); the client at cohort
position p trains with ``split(train_key, cohort)[p]`` (its batch orders
and bf16 rounding salt, parallel/engine.py ``client_draws``); the payload
hooks' salts come from ``payload_key`` and ``agg_key``.

The cohort is every client, or with ``participation_fraction < 1`` the
``cohort_size()`` clients drawn by ``participation_sampler``; only the
cohort trains, and the weights are normalized over the cohort's sizes.

Two ways to combine the uploads:

* **The mean path** (``aggregation='mean'``, no client stack asked for):
  each upload is added, with weight ``w_p = size_p / sum(cohort sizes)``,
  into an f32 aggregate (f32 even when the client params are bf16). The
  clients train a chunk at a time, as one vmapped program per chunk
  (parallel/engine.py ``make_chunk_train_fn``), in the order the JAX fused
  path reduces them: without the size-aware schedule, chunks of
  ``client_chunk_size`` cohort positions in order (the last chunk may be a
  remainder; no chunk size: the whole cohort at once); with it
  (``bucket_client_work``, full participation only), the ``_bucket_plan``
  groups in descending step count, each group chunked the same way; a
  client in a group with ``s`` steps trains on its first ``s * batch_size``
  slots, so its epoch permutations run over that many slots. Empty clients
  are skipped. Each chunk's weighted sum (one f32 contraction of its
  weights with its uploads, the JAX package's ``tensordot``) is
  accumulated separately and added into its group's, and the groups into
  the aggregate, as the JAX program adds its partial sums.
* **The materializing path** (``materializes_client_stack``: a robust rule,
  ``client_eval``, or ``keep_client_params``): the cohort trains on its
  whole shards, chunk by chunk in cohort order, and each client's processed
  upload, in f32, becomes row p of a ``[cohort, P]`` stack;
  ``ops/aggregate.aggregate`` combines the stack by ``config.aggregation``.
  A robust rule whose result is not finite keeps the previous global
  model. With ``keep_client_params`` (the Shapley
  algorithms) the stack is ``aux["client_params"]``.

A round whose cohort weight is 0 keeps the previous global model.

With a failure model (robustness/faults.py) a failed client's upload
weighs nothing (dropout, straggler) or is garbage at full weight (the
corrupt modes, applied to its raw params before the payload hooks), and a
dropout's persistent state stays as it was; the clients still train in
their chunks as before. The quorum guard (a failure model, or
``min_survivors > 0``) rejects a round whose survivors fall below
``min_survivors`` or whose aggregate is not finite: the round returns the
previous global model, after ``process_aggregated``, and reports
``survivor_count`` and ``round_rejected``. ``make_server_update`` gives
the FedOpt server step (FedAvgM, FedAdam) the simulator applies.

Template hooks for subclasses (fed_quant): ``client_param_transform``
(applied to the params inside the loss and in client eval),
``process_client_payload`` (each client's upload, before it is weighted)
and ``process_aggregated`` (the broadcast). The JAX hooks take PRNG keys;
here they take per-leaf 32-bit salts, which the round derives from the
payload keys exactly as the JAX hooks fold theirs: per chunk of the
reduction order (or the whole cohort on the materializing path) a key is
split into one key per client, and each client's into one salt per leaf.
``process_client_payload`` takes a chunk's ``[M, P]`` uploads with their
``[M, n_leaves]`` salts.

``make_fleet_round_fn`` is the round body over a sweep's E experiments
(sweep/engine.py): each experiment's host draws as in its solo round, and
chunk j of every experiment trained as one program of E x M models.

With ``client_stats='on'`` (telemetry/client_stats.py) the round also
returns ``aux["client_stats"]``, the cohort's ``[N, S]`` stats matrix: the
chunk train function reports each client's first-step loss and mean squared
gradient norm, and each chunk's uploads, after fault corruption and before
the payload hook, give their update norms, non-finite counts and a strided
probe, per chunk on the mean paths (the ``[N, P]`` stack is never held) and
on the stack on the materializing path; the aggregate's probe is taken
before the quorum select and the downlink hook. Rows of clients the
size-aware schedule skips stay zero, as in the JAX program. With it off the
round is the pre-feature round.

``client_eval`` (auto: on for fed_quant at cohorts <= 32): each chunk's raw
models, cast to f32, are evaluated through the transform in one vmapped
forward right after they train, before their payloads are processed, and
post_round reports the ``client_eval`` record sub-object.

With ``client_valuation='on'`` (telemetry/valuation.py) the round also
returns ``aux["valuation_scores"]``, the cohort's streaming scores from the
stats matrix. ``make_valuation_audit_fn`` builds the audit's replay of a
round's cohort training.

With ``async_mode='on'`` (robustness/arrivals.py) the round takes the
staleness buffer as ``async_state``: the host draws each cohort client's
latency and splits the cohort against the deadline; the on-time clients
form the fresh mean exactly as a synchronous round would (the same
weights, the same contraction), the late ones a second weighted sum with
their discounted weights, which the buffer absorbs; the round returns the
next buffer state as ``aux["async_state"]`` with the v4 record's scalars.

A round never waits on the card to decide anything: the quorum verdict,
a robust rule's finiteness fallback and the buffer's trigger are selects
on the device (``aux["round_rejected"]`` is a device bool), and host
index and weight vectors go to the card as asynchronous copies from
pinned memory (ops/cohort.to_device). That is what lets the simulator run
``rounds_per_dispatch`` rounds back to back with one metric fetch.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_learning_simulator_tpu_torch.algorithms.base import Algorithm
from distributed_learning_simulator_tpu_torch.ops import prng
from distributed_learning_simulator_tpu_torch.ops.aggregate import aggregate
from distributed_learning_simulator_tpu_torch.ops.augment import get_augment
from distributed_learning_simulator_tpu_torch.ops.cohort import (
    cohort_scatter,
    cohort_take,
    set_rows,
    to_device,
)
from distributed_learning_simulator_tpu_torch.ops.quantize import Segments
from distributed_learning_simulator_tpu_torch.ops.sampling import (
    draw_cohort_host,
)
from distributed_learning_simulator_tpu_torch.parallel.engine import (
    Adam,
    client_draws,
    fma,
    make_chunk_train_fn,
    make_models_eval_fn,
    stack_draws,
)
from distributed_learning_simulator_tpu_torch.robustness.arrivals import (
    AsyncFederation,
)
from distributed_learning_simulator_tpu_torch.robustness.faults import (
    FailureModel,
    finite_flag,
)
from distributed_learning_simulator_tpu_torch.telemetry.client_stats import (
    ClientStats,
)
from distributed_learning_simulator_tpu_torch.telemetry.valuation import (
    ClientValuation,
)
from distributed_learning_simulator_tpu_torch.utils.logging import get_logger


def round_key_splits(key, with_faults: bool = False):
    """The round key's split chain, as the JAX package's
    ``round_key_splits(key, with_faults)``: ``(part_key, train_key,
    payload_key, agg_key, fault_key)``. The fault split is made only with a
    failure model, so a run without one keeps the exact 4-way stream
    (``fault_key`` is then None)."""
    if with_faults:
        return tuple(prng.split(key, 5))
    part_key, train_key, payload_key, agg_key = prng.split(key, 4)
    return part_key, train_key, payload_key, agg_key, None


def chunk_keys(group_key, n_members: int, chunk: int | None):
    """The per-chunk payload keys of one reduction group, as the JAX
    package's fused path takes them: the group's own key when it is one
    chunk, else ``split(group_key, n_full_chunks + 1)`` with chunk j taking
    key j (a remainder chunk takes the last)."""
    if chunk is None or chunk <= 0 or n_members <= chunk:
        return [group_key]
    return list(prng.split(group_key, n_members // chunk + 1))


def _bucket_sizes(cfg, client_sizes, materialize: bool, sampled: bool):
    """The client sizes the size-aware schedule plans with
    (``bucket_client_work`` on the mean path under full participation with
    a chunk size), or None for the plain path."""
    chunk = cfg.client_chunk_size
    if (
        client_sizes is not None
        and cfg.bucket_client_work
        and not materialize
        and not sampled
        and chunk is not None
        and chunk > 0
    ):
        return np.asarray(client_sizes, dtype=np.int64)
    return None


def _bucket_plan(bucket_sizes, bsz: int, chunk: int, total_steps: int):
    """{steps -> client indices}: clients sorted by needed step count, cut
    into chunks, chunks grouped by their largest member's steps; empty
    clients go to the s=0 group."""
    steps_c = np.minimum(-(-bucket_sizes // bsz), total_steps)
    groups: dict[int, list[np.ndarray]] = {}
    empty = np.flatnonzero(steps_c == 0)
    if empty.size:
        groups[0] = [empty]
    nonzero = np.flatnonzero(steps_c > 0)
    order = nonzero[np.argsort(-steps_c[nonzero], kind="stable")]
    for start in range(0, order.size, chunk):
        sl = order[start:start + chunk]
        groups.setdefault(int(steps_c[sl[0]]), []).append(sl)
    return {s: np.concatenate(g) for s, g in groups.items()}


def reduction_schedule(bucket_sizes, bsz: int, chunk, n_participants: int,
                       shard_size: int, payload_key):
    """The mean path's reduction order: ``[(slots, [(chunk payload key,
    [cohort positions, ...]), ...]), ...]``. The group keys are the JAX
    program's: ``payload_key`` for the plain path, else one split per plan
    group (the s=0 group, last, trains nothing). It depends on the shared
    client sizes only, never on the cohort drawn, so every experiment of a
    sweep fleet has the same groups and chunks."""
    plan = None
    if bucket_sizes is not None:
        plan = _bucket_plan(bucket_sizes, bsz, chunk, shard_size // bsz)
        if len(plan) <= 1:
            plan = None  # uniform work: the plain path
    if plan is None:
        groups = [(shard_size, np.arange(n_participants))]
        group_keys = [payload_key]
    else:
        groups = [(s * bsz, idx) for s, idx in
                  sorted(plan.items(), reverse=True) if s > 0]
        group_keys = prng.split(payload_key, len(plan))
    out = []
    for (slots, idx), gk in zip(groups, group_keys):
        if chunk is None or chunk <= 0 or chunk >= idx.size:
            chunks = [idx]
        else:
            chunks = [idx[i:i + chunk] for i in range(0, idx.size, chunk)]
        keys = chunk_keys(gk, idx.size, chunk)
        out.append((slots, [
            (keys[j], [int(p) for p in ch]) for j, ch in enumerate(chunks)
        ]))
    return out


def _select(rejected: torch.Tensor, old, new):
    """``old`` where the device bool ``rejected`` holds, else ``new``, leaf
    by leaf over a tensor or a dict of them; a leaf on another device (the
    host step count of Adam) is decided on the host."""
    if isinstance(old, dict):
        return {k: _select(rejected, old[k], new[k]) for k in old}
    if old is None:
        return None
    if old.device != rejected.device:
        return old if bool(rejected) else new
    return torch.where(rejected, old, new)


class FedAvg(Algorithm):
    name = "fed"
    #: Whether the payload hooks use salts (the round derives them only then).
    payload_salted = False
    #: The round function takes the staleness buffer (async_mode='on');
    #: fed_quant inherits it.
    supports_async = True

    def __init__(self, config):
        super().__init__(config)
        ce = config.client_eval
        if ce is None:
            ce = self.name == "fed_quant" and config.cohort_size() <= 32
            if self.name == "fed_quant" and not ce:
                get_logger().info(
                    "client_eval auto-disabled: cohort size %d > 32 (the "
                    "per-client eval needs the materializing path); pass "
                    "client_eval=True to force it",
                    config.cohort_size(),
                )
        self._client_eval_enabled = bool(ce)
        self._eval_fn = None
        self._eval_batches = None
        self.segments = None  # the flat params' leaves, set per round fn

    @property
    def materializes_client_stack(self) -> bool:
        """Whether the round keeps every cohort client's upload as a stack
        (the materializing path)."""
        return (
            bool(self.keep_client_params)
            or self._client_eval_enabled
            or self.config.aggregation.lower() != "mean"
        )

    @property
    def supports_round_batching(self) -> bool:
        """``rounds_per_dispatch > 1`` stacks every round's aux over the
        dispatch, so a round must not carry a per-round parameter stack
        (``keep_client_params``) or need post_round on each round's own
        stack (``client_eval``)."""
        return not (self.keep_client_params or self._client_eval_enabled)

    def prepare(self, apply_fn, eval_fn, eval_batches=None):
        self._eval_fn = eval_fn
        self._eval_batches = eval_batches

    #: The streamed round is the resident round after the gather
    #: (``make_round_fn`` builds it under client_residency='streamed'
    #: with a sampled cohort);
    #: fed_quant inherits it.
    supports_streamed_residency = True

    def cohort_indices(self, round_key, n_clients: int, alive=None,
                       n_participants=None):
        """The round's cohort (true client ids) as ``make_round_fn``'s round
        draws it from ``round_key``; None under full participation.
        ``alive`` (bool ``[n_clients]``) and ``n_participants`` are the
        dynamic population's: a hashed draw over the registered index space
        with the departed masked, at the startup cohort size
        (ops/sampling.py validates the mask)."""
        cfg = self.config
        if n_participants is None:
            n_participants = cfg.cohort_size(n_clients)
        if n_participants == n_clients:
            return None
        with_faults = FailureModel.from_config(cfg) is not None
        return draw_cohort_host(
            round_key_splits(round_key, with_faults)[0], n_clients,
            n_participants, cfg.participation_sampler.lower(), alive=alive,
        )

    # Template hooks (identity here; fed_quant overrides them). The payload
    # hooks return (value, extra_aux).
    def client_param_transform(self):
        """Flat -> flat transform applied to the params inside the loss and
        in client eval; None for none."""
        return None

    def process_client_payload(self, client_params, salts):
        """A chunk's uploads ``[M, P]`` with their salts ``[M, n_leaves]``
        (None when unsalted) -> ``(processed [M, P], extra_aux)``."""
        return client_params, {}

    def process_aggregated(self, global_params, salts):
        return global_params, {}

    def _chunk_train_fn(self, apply_fn, optimizer, layout, preprocess,
                        device, collect_stats: bool = False):
        """The round's chunk train function
        (:func:`~..parallel.engine.make_chunk_train_fn`) at the config's
        local settings, with the client param transform."""
        cfg = self.config
        return make_chunk_train_fn(
            apply_fn, optimizer, layout,
            local_epochs=cfg.epoch,
            batch_size=cfg.batch_size,
            preprocess=preprocess,
            compute_dtype=(torch.bfloat16
                           if cfg.local_compute_dtype == "bfloat16"
                           else None),
            device=device,
            param_transform=self.client_param_transform(),
            reset_optimizer=cfg.reset_client_optimizer,
            augment=get_augment(cfg.augment),
            collect_stats=collect_stats,
        )

    def make_round_fn(self, apply_fn, optimizer, layout, n_clients: int,
                      preprocess=None, client_sizes=None, device=None):
        self.check_cohort(n_clients)
        cfg = self.config
        bsz = cfg.batch_size
        chunk = cfg.client_chunk_size
        self.segments = Segments(layout.numels, device)
        transform = self.client_param_transform()
        augment = get_augment(cfg.augment)
        client_eval = self._client_eval_enabled
        materialize = self.materializes_client_stack
        keep_stack = bool(self.keep_client_params)
        aggregation = cfg.aggregation.lower()
        n_participants = cfg.cohort_size(n_clients)
        sampled = n_participants < n_clients
        # Failure model + quorum policy (robustness/faults.py): without a
        # failure model and with min_survivors=0 nothing below changes the
        # round. min_survivors alone still turns the quorum guard on.
        fm = FailureModel.from_config(cfg)
        min_survivors = cfg.min_survivors
        quorum = fm is not None or min_survivors > 0
        # Per-client statistics: None (the default) builds the pre-feature
        # round; so does valuation off, and async off.
        cs = ClientStats.from_config(cfg)
        cv = ClientValuation.from_config(cfg)
        af = AsyncFederation.from_config(cfg)
        arrival_speeds = (af.speed_table(n_clients) if af is not None
                          else None)
        if client_eval and self._eval_fn is None:
            raise RuntimeError(
                "client_eval needs prepare(apply_fn, eval_fn, eval_batches) "
                "before make_round_fn"
            )
        train_chunk = self._chunk_train_fn(apply_fn, optimizer, layout,
                                           preprocess, device,
                                           collect_stats=cs is not None)
        n_leaves = len(layout.numels)
        evaluate_models = (
            make_models_eval_fn(self._eval_fn, layout, transform)
            if client_eval else None
        )

        bucket_sizes = _bucket_sizes(cfg, client_sizes, materialize, sampled)

        def round_fn(global_flat, client_state, cx, cy, cmask, sizes, key,
                     lr_scale=1.0, client_rng=None, payload_salts=None,
                     async_state=None, cohort=None, departed=None):
            """``sizes`` is the host f32 ``[n_clients]`` weight vector,
            ``key`` the round key (ops/prng.py); ``client_state`` is None,
            or with ``reset_client_optimizer=False`` each client's optimizer
            state stacked ``[n_clients, P]`` (f32; the cohort's rows are
            taken, trained from and scattered back, the others keep
            theirs). ``client_rng(client, n_slots) -> (epoch_perms,
            sr_salt[, aug_key])`` and ``payload_salts(client) -> [n_leaves]
            salts`` (``client=None``: the broadcast's) optionally replace
            the key chain's draws (tests).

            With a failure model, ``failed`` (bool per cohort position, from
            the fault key) zeroes a dropout's or straggler's weight, turns a
            corrupt client's raw upload into garbage, and freezes a
            dropout's persistent state. With the quorum guard,
            ``aux["survivor_count"]`` and ``aux["round_rejected"]`` (a
            device bool) report the round, and a rejected round returns the
            previous global model exactly.

            ``async_state`` (async_mode='on'): the staleness buffer
            (``AsyncFederation.init_state``); the next one is
            ``aux["async_state"]``.

            ``cohort`` (the streamed entry below) is ``(ids, rows)``: the
            arguments are then already the cohort's (its data slices,
            sizes and state), ``ids`` its true client ids and ``rows`` the
            rows of ``cx``/``cy``/``cmask`` that hold them, and the
            cohort's new state is returned unscattered. The same body
            serves both, which is what makes the two residency modes
            bitwise equal. ``departed`` (bool per cohort position,
            population='dynamic') zeroes the weight of a member that
            departs this round and counts it against the quorum floor."""
            if af is not None and async_state is None:
                raise ValueError(
                    "async_mode='on' round program needs the async_state "
                    "operand (AsyncFederation.init_state)"
                )
            _, train_key, payload_key, agg_key, fault_key = round_key_splits(
                key, fm is not None)
            failed = (fm.draw_failed(fault_key, n_participants)
                      if fm is not None else None)
            if cohort is None:
                ids = self.cohort_indices(key, n_clients)
                if ids is None:
                    ids = np.arange(n_clients)
                data_rows = ids
                part_sizes = np.asarray(sizes, dtype=np.float32)[ids]
                state_k = cohort_take(client_state, ids)
            else:
                ids, data_rows = cohort
                part_sizes = np.asarray(sizes, dtype=np.float32)
                state_k = client_state
            client_keys = prng.split(train_key, n_participants)
            pos_of = {int(i): p for p, i in enumerate(ids)}
            if materialize:
                plan = [(cx.shape[1], [(payload_key,
                                        list(range(n_participants)))])]
            else:
                plan = reduction_schedule(bucket_sizes, bsz, chunk,
                                          n_participants, cx.shape[1],
                                          payload_key)
            if client_rng is None:
                def client_rng(i, n_slots):
                    return client_draws(client_keys[pos_of[i]], n_slots,
                                        cfg.epoch,
                                        augment=augment is not None)
            if payload_salts is None and self.payload_salted:
                salt_of = {None: prng.leaf_salts(agg_key, n_leaves)}
                for _, chunks in plan:
                    for ck, members in chunks:
                        for q, k in zip(members,
                                        prng.split(ck, len(members))):
                            salt_of[int(ids[q])] = prng.leaf_salts(
                                k, n_leaves)
                payload_salts = salt_of.__getitem__
            elif payload_salts is None:
                def payload_salts(i):
                    return None
            if departed is not None:
                # A member departing mid-round contributes nothing: the
                # rest of the cohort renormalizes, as under dropout.
                part_sizes = part_sizes * (~departed).astype(np.float32)
            survival = None if failed is None else ~failed
            routed_late = None
            if failed is not None and fm.excludes_update:
                if af is not None and fm.routes_to_buffer:
                    # A straggler's upload arrives after the deadline: into
                    # the buffer at its weight, and the client survives.
                    routed_late = failed
                    survival = np.ones_like(failed)
                else:
                    # The weighted mean renormalizes over the survivors;
                    # the robust rules' weight > 0 mask leaves the failed
                    # out.
                    part_sizes = part_sizes * (~failed).astype(np.float32)
            late_w = None
            if af is not None:
                # Latencies from the fold_in-decoupled arrival stream, by
                # true client id; the split chain above is untouched.
                latency = af.draw_latency(key, ids, arrival_speeds[ids])
                on_time, staleness, discount, eff_latency = af.classify(
                    latency, routed_late)
                sim_duration, sim_duration_sync = af.durations(eff_latency)
                late_mask = (~on_time) & (part_sizes > 0)
                late_w = (part_sizes * discount
                          * late_mask.astype(np.float32)).astype(np.float32)
                b_tot = late_w.sum(dtype=np.float32)
                n_late = int(late_mask.sum())
                mean_staleness = np.float32(
                    (staleness * late_mask.astype(np.float32)).sum(
                        dtype=np.float32) / np.float32(max(n_late, 1)))
                # The fresh cohort is the on-time clients; a late client
                # contributes through the buffer only.
                part_sizes = part_sizes * on_time.astype(np.float32)
            total = part_sizes.sum(dtype=np.float32)
            norm_w = part_sizes / np.maximum(total, np.float32(1e-12))
            losses = torch.zeros(n_participants, device=global_flat.device)
            accs = torch.zeros_like(losses)
            eval_accs = torch.zeros_like(losses) if client_eval else None
            stat_rows = None
            if cs is not None:
                # Per-client rows, zero for a client the round skips.
                k = cs.probe_size(layout.numels)
                stat_rows = {
                    name: torch.zeros_like(losses) for name in (
                        "loss_first", "grad_sq_mean", "update_sq",
                        "nonfinite_count")
                }
                stat_rows["stat_probe"] = torch.zeros(
                    (n_participants, k), device=losses.device)

            def train(members, slots):
                """The cohort positions ``members`` as one chunk on their
                first ``slots`` slots; returns their ``[M, P]`` params."""
                pos = to_device(members, global_flat.device, torch.long)
                rows = to_device(data_rows[members], cx.device, torch.long)
                perms, salts, aug_keys = stack_draws(
                    [client_rng(int(ids[p]), slots) for p in members])
                old_state = cohort_take(state_k, pos)
                params, state, metrics = train_chunk(
                    global_flat, cx[rows, :slots], cy[rows, :slots],
                    cmask[rows, :slots], perms, salts, aug_keys=aug_keys,
                    lr_scale=lr_scale, opt_state=old_state,
                )
                if state_k is not None:
                    if failed is not None and fm.freezes_client_state:
                        state = fm.freeze_failed_state(failed[members],
                                                       old_state, state)
                    set_rows(state_k, pos, state)
                losses[pos] = metrics["loss"]
                accs[pos] = metrics["accuracy"]
                if stat_rows is not None:
                    for name in ("loss_first", "grad_sq_mean"):
                        stat_rows[name][pos] = metrics[name]
                return params

            def payload(members, params):
                """The members' uploads: the corrupt modes damage the raw
                params first, as the client's own payload transform would
                see them."""
                if failed is not None and fm.corrupts_upload:
                    params = fm.corrupt_stack(params, failed[members])
                if stat_rows is not None:
                    # What the server receives: after the corruption,
                    # before the payload hook.
                    pos = to_device(members, global_flat.device, torch.long)
                    up = cs.add_upload_stats({}, global_flat, params,
                                             layout.numels)
                    for name, v in up.items():
                        stat_rows[name][pos] = v
                salts = [payload_salts(int(ids[p])) for p in members]
                if salts[0] is None:
                    salts = None
                return self.process_client_payload(params, salts)[0]

            aux = {}
            if materialize:
                stack = torch.empty((n_participants,) + global_flat.shape,
                                    dtype=torch.float32,
                                    device=global_flat.device)
                step = chunk if chunk else n_participants
                for start in range(0, n_participants, step):
                    members = list(range(start,
                                         min(start + step, n_participants)))
                    # f32, as the JAX package casts the stack for the rules.
                    params = train(members, cx.shape[1]).float()
                    if client_eval:
                        eval_accs[start:start + len(members)] = (
                            evaluate_models(params, *self._eval_batches)[
                                "accuracy"])
                    stack[start:start + len(members)] = payload(members,
                                                                params)
                if late_w is not None:
                    late_sum = torch.tensordot(
                        to_device(late_w, stack.device), stack, dims=1)
                new_global = aggregate(stack, part_sizes, aggregation,
                                       cfg.trim_ratio)
                if aggregation != "mean" and not quorum:
                    # Every candidate diverged: keep the previous model (the
                    # quorum guard, when on, rejects such a round instead).
                    new_global = torch.where(
                        finite_flag(new_global), new_global,
                        global_flat.to(new_global.dtype))
                if keep_stack:
                    aux["client_params"] = stack
            else:
                new_global = torch.zeros_like(global_flat,
                                              dtype=torch.float32)
                if late_w is not None:
                    late_sum = torch.zeros_like(new_global)
                for slots, chunks in plan:
                    group_acc = torch.zeros_like(new_global)
                    late_acc = (torch.zeros_like(new_global)
                                if late_w is not None else None)
                    for _, members in chunks:
                        uploads = payload(members, train(members, slots))
                        w = to_device(norm_w[members], uploads.device)
                        group_acc += torch.tensordot(w, uploads.float(),
                                                     dims=1)
                        if late_acc is not None:
                            # The late row: a second contraction of the same
                            # uploads, so the fresh row's ops are those of
                            # the synchronous round.
                            lw = to_device(late_w[members], uploads.device)
                            late_acc += torch.tensordot(lw, uploads.float(),
                                                        dims=1)
                    new_global += group_acc
                    if late_acc is not None:
                        late_sum += late_acc
            if af is not None:
                # The buffer: insert the late batch, fire the trigger, mix
                # the buffered mean delta in. A round the whole cohort
                # missed is still an update when the buffer applies.
                new_global, applied, state_ins, state_next = (
                    af.absorb_and_apply(async_state, global_flat, new_global,
                                        total, late_sum, b_tot, n_late,
                                        sim_duration))
                new_global = torch.where(
                    applied | bool(total > 0), new_global,
                    global_flat.to(new_global.dtype))
            elif not total > 0:
                # Empty effective cohort: keep the previous global model.
                new_global = global_flat
            if cs is not None:
                # The aggregate's probe from the raw round aggregate:
                # before the quorum select and the downlink hook.
                aux["client_stats"] = cs.stats_matrix(
                    dict(stat_rows, loss=losses),
                    cs.probe_delta(global_flat, new_global, layout.numels),
                )
                if cv is not None:
                    # The streaming valuation scores, from the same matrix.
                    aux["valuation_scores"] = cv.scores(aux["client_stats"])
            rejected = None
            if quorum:
                # Rejected when the survivors fall below min_survivors or the
                # aggregate is not finite (the plain mean would carry a NaN
                # upload into the global model for good).
                if departed is not None:
                    # Departures alone can push a round below the floor.
                    survival = (~departed if survival is None
                                else survival & ~departed)
                survivor_count = (int(survival.sum()) if survival is not None
                                  else n_participants)
                rejected = (~finite_flag(new_global)
                            | bool(survivor_count < min_survivors))
                aux["survivor_count"] = survivor_count
                aux["round_rejected"] = rejected
            new_global, agg_aux = self.process_aggregated(
                new_global, payload_salts(None)
            )
            if rejected is not None:
                # After the downlink transform, so that a rejected round
                # keeps the previous global model exactly (fed_quant would
                # otherwise re-quantize it with fresh noise).
                new_global = torch.where(
                    rejected, global_flat.to(new_global.dtype), new_global)
            if af is not None:
                if rejected is not None:
                    # A rejected round keeps its inserts (the late uploads
                    # arrived) but not the trigger's reset.
                    state_next = {
                        k: torch.where(rejected, state_ins[k], state_next[k])
                        for k in state_next
                    }
                    applied = applied & ~rejected
                aux["async_state"] = state_next
                aux.update({
                    "on_time_count": int((part_sizes > 0).sum()),
                    "late_count": n_late,
                    "buffer_count": state_next["buf_count"],
                    "buffer_applied": applied,
                    "mean_staleness": mean_staleness,
                    "sim_duration": sim_duration,
                    "sim_duration_sync": sim_duration_sync,
                    "sim_clock": state_next["clock"],
                })
            aux.update({
                "client_loss": losses,
                "client_accuracy": accs,
                "mean_client_loss": losses.mean(),
                **agg_aux,
            })
            if client_eval:
                aux["client_eval_accuracy"] = eval_accs
            if cohort is not None:
                return new_global, state_k, aux
            if sampled:
                aux["participants"] = np.asarray(ids)
            if state_k is not None:
                client_state = cohort_scatter(client_state, ids, state_k)
            return new_global, client_state, aux

        if (cfg.client_residency.lower() != "streamed"
                or cfg.cohort_size(n_clients) >= n_clients):
            # A full streamed cohort runs the resident round on the
            # population's arrays, uploaded once.
            return round_fn
        dyn = cfg.population.lower() == "dynamic"

        def round_fn_streamed(global_flat, state_k, x_k, y_k, m_k,
                              part_sizes, idx, key, lr_scale=1.0,
                              client_rng=None, payload_salts=None,
                              async_state=None, departed=None):
            """The streamed calling convention (algorithms/base.py): the
            cohort's slices arrive gathered from the host shard store,
            ``idx`` is its true client ids, and the cohort's new state is
            returned for the streamer to write back. The round key splits
            as in the resident round (the host drew the cohort from its
            ``part_key``). ``departed`` (population='dynamic', required
            there) is the registration stream's departure mask over the
            cohort."""
            if dyn and departed is None:
                raise ValueError(
                    "population='dynamic' round program needs the "
                    "departed operand "
                    "(PopulationModel.cohort_departed_mask)"
                )
            cohort = (np.asarray(idx), np.arange(len(idx)))
            new_global, state_k, aux = round_fn(
                global_flat, state_k, x_k, y_k, m_k, part_sizes, key,
                lr_scale, client_rng, payload_salts, async_state,
                cohort=cohort,
                departed=(np.asarray(departed, dtype=bool)
                          if dyn else None))
            aux["participants"] = cohort[0]
            return new_global, state_k, aux

        return round_fn_streamed

    def make_fleet_round_fn(self, apply_fn, optimizer, layout,
                            n_clients: int, preprocess=None,
                            client_sizes=None, device=None):
        """The round body over E experiments at once (the sweep fleet,
        sweep/engine.py): ``fleet_round(globals_e [E, P], cx, cy, cmask,
        sizes, round_keys, lr_scale=1.0) -> (new_globals [E, P], auxes)``,
        ``round_keys`` the E experiments' round keys and ``auxes`` their E
        aux dicts, each the one the solo round returns.

        Per experiment, on the host, exactly as the solo round draws them:
        the round key's splits, the cohort, the failure mask, the weights
        and each member's batch orders and rounding salt. Shared on the
        device: the loop over the reduction order's chunks. Chunk j of
        every experiment trains as one ``train_chunk`` call of E x M rows,
        row ``e * M + m`` experiment e's member m, from e's global model
        (each row rounded to bf16 with its own salt, as in the solo
        chunk), and each experiment then accumulates the solo contraction
        of its weights with its own contiguous slice of the uploads, in
        the solo order. ``lr_scale`` is a float for every row or an f32
        ``[E]`` factor per experiment. Per experiment after the loop: the
        empty-cohort keep, the quorum select and the downlink hook.

        Serves what ``SweepSpec.fleet_compatible`` admits: the mean path
        with the optimizer reset every round, optionally a cohort sample,
        the size-aware schedule (its plan depends on the shared sizes
        only), a failure model and a quorum."""
        self.check_cohort(n_clients)
        cfg = self.config
        if (self.materializes_client_stack or self.payload_salted
                or not cfg.reset_client_optimizer):
            raise ValueError(
                "the experiment fleet runs fed's mean path without "
                "persistent client state (SweepSpec.fleet_compatible)"
            )
        bsz = cfg.batch_size
        chunk = cfg.client_chunk_size
        augment = get_augment(cfg.augment)
        n_participants = cfg.cohort_size(n_clients)
        sampled = n_participants < n_clients
        fm = FailureModel.from_config(cfg)
        min_survivors = cfg.min_survivors
        quorum = fm is not None or min_survivors > 0
        train_chunk = self._chunk_train_fn(apply_fn, optimizer, layout,
                                           preprocess, device)
        bucket_sizes = _bucket_sizes(cfg, client_sizes, False, sampled)

        def plan_experiment(key, sizes):
            """One experiment's host draws for the round (the solo round's
            first half)."""
            _, train_key, payload_key, _, fault_key = round_key_splits(
                key, fm is not None)
            failed = (fm.draw_failed(fault_key, n_participants)
                      if fm is not None else None)
            ids = self.cohort_indices(key, n_clients)
            if ids is None:
                ids = np.arange(n_clients)
            part_sizes = np.asarray(sizes, dtype=np.float32)[ids]
            if failed is not None and fm.excludes_update:
                part_sizes = part_sizes * (~failed).astype(np.float32)
            total = part_sizes.sum(dtype=np.float32)
            return {
                "ids": ids, "failed": failed, "total": total,
                "norm_w": part_sizes / np.maximum(total, np.float32(1e-12)),
                "client_keys": prng.split(train_key, n_participants),
                "payload_key": payload_key,
            }

        def fleet_round(globals_e, cx, cy, cmask, sizes, round_keys,
                        lr_scale=1.0):
            n_exp = len(round_keys)
            dev = globals_e.device
            exps = [plan_experiment(k, sizes) for k in round_keys]
            # The groups and chunks depend on the shared sizes only; fed
            # reads no chunk payload key, so any experiment's plan serves.
            plan = reduction_schedule(bucket_sizes, bsz, chunk,
                                      n_participants, cx.shape[1],
                                      exps[0]["payload_key"])
            row_scale = lr_scale
            losses = [torch.zeros(n_participants, device=dev)
                      for _ in range(n_exp)]
            accs = [torch.zeros_like(v) for v in losses]
            new = [torch.zeros_like(g, dtype=torch.float32)
                   for g in globals_e]
            for slots, chunks in plan:
                group_acc = [torch.zeros_like(v) for v in new]
                for _, members in chunks:
                    m = len(members)
                    pos = to_device(members, dev, torch.long)
                    rows = to_device(
                        np.concatenate([x["ids"][members] for x in exps]),
                        cx.device, torch.long)
                    perms, salts, aug_keys = stack_draws([
                        client_draws(x["client_keys"][p], slots, cfg.epoch,
                                     augment=augment is not None)
                        for x in exps for p in members
                    ])
                    if isinstance(lr_scale, torch.Tensor):
                        row_scale = lr_scale.repeat_interleave(m)
                    params, _, metrics = train_chunk(
                        globals_e.repeat_interleave(m, dim=0),
                        cx[rows, :slots], cy[rows, :slots],
                        cmask[rows, :slots], perms, salts,
                        aug_keys=aug_keys, lr_scale=row_scale,
                    )
                    for e, x in enumerate(exps):
                        sl = slice(e * m, (e + 1) * m)
                        losses[e][pos] = metrics["loss"][sl]
                        accs[e][pos] = metrics["accuracy"][sl]
                        uploads = params[sl]
                        if x["failed"] is not None and fm.corrupts_upload:
                            uploads = fm.corrupt_stack(
                                uploads, x["failed"][members])
                        uploads = self.process_client_payload(uploads,
                                                              None)[0]
                        w = to_device(x["norm_w"][members], uploads.device)
                        group_acc[e] += torch.tensordot(
                            w, uploads.float(), dims=1)
                for e in range(n_exp):
                    new[e] += group_acc[e]
            out, auxes = [], []
            for e, x in enumerate(exps):
                new_global = new[e] if x["total"] > 0 else globals_e[e]
                aux = {}
                rejected = None
                if quorum:
                    survivor_count = (
                        int((~x["failed"]).sum()) if x["failed"] is not None
                        else n_participants)
                    rejected = (~finite_flag(new_global)
                                | bool(survivor_count < min_survivors))
                    aux["survivor_count"] = survivor_count
                    aux["round_rejected"] = rejected
                new_global, agg_aux = self.process_aggregated(new_global,
                                                              None)
                if rejected is not None:
                    new_global = torch.where(
                        rejected, globals_e[e].to(new_global.dtype),
                        new_global)
                aux.update({
                    "client_loss": losses[e],
                    "client_accuracy": accs[e],
                    "mean_client_loss": losses[e].mean(),
                    **agg_aux,
                })
                if sampled:
                    aux["participants"] = np.asarray(x["ids"])
                out.append(new_global)
                auxes.append(aux)
            return torch.stack(out), auxes

        return fleet_round

    def make_valuation_audit_fn(self, apply_fn, optimizer, layout,
                                preprocess=None, device=None):
        """The valuation audit's replay of a round's cohort training
        (telemetry/valuation.py): ``audit_stack(global_flat, cx, cy, cmask,
        ids, client_keys, payload_key, lr_scale) -> [cohort, P]`` f32, the
        cohort's processed uploads.

        As in the JAX package, the cohort trains from the pre-round global
        model on its whole shards, ``client_chunk_size`` clients at a time
        in cohort order, through the round's own chunk train function
        (:func:`~..parallel.engine.make_chunk_train_fn`: the same grouped
        convolutions and kernel shapes), each client with its round key
        ``client_keys[p]``; only the stats are not collected, which changes
        no trained parameter. The audit's preconditions (plain ``fed``, no
        faults, no async, no persistent client state, config.validate())
        make ``process_client_payload`` the identity. Under
        ``bucket_client_work`` the live round trains a client on its
        group's slots only, so there (as in the JAX package) the replay is
        the unscheduled round's training, not the scheduled one's."""
        cfg = self.config
        augment = get_augment(cfg.augment)
        train_chunk = self._chunk_train_fn(apply_fn, optimizer, layout,
                                           preprocess, device)
        chunk = cfg.client_chunk_size

        def audit_stack(global_flat, cx, cy, cmask, ids, client_keys,
                        payload_key, lr_scale=1.0):
            n = len(ids)
            n_slots = cx.shape[1]
            stack = torch.empty((n,) + global_flat.shape,
                                dtype=torch.float32,
                                device=global_flat.device)
            step = chunk if chunk else n
            for start in range(0, n, step):
                members = list(range(start, min(start + step, n)))
                rows = to_device(np.asarray(ids)[members], cx.device,
                                 torch.long)
                perms, salts, aug_keys = stack_draws([
                    client_draws(client_keys[p], n_slots, cfg.epoch,
                                 augment=augment is not None)
                    for p in members
                ])
                params, _, _ = train_chunk(
                    global_flat, cx[rows], cy[rows], cmask[rows], perms,
                    salts, aug_keys=aug_keys, lr_scale=lr_scale,
                )
                stack[start:start + len(members)] = params.float()
            return self.process_client_payload(stack, None)[0]

        return audit_stack

    def post_round(self, ctx):
        """The ``client_eval`` record sub-object: the clients' pre-
        aggregation accuracies (mean/min/max) and the global model's."""
        if not self._client_eval_enabled:
            return {}
        accs = ctx.aux.get("client_eval_accuracy")
        if accs is None:
            raise RuntimeError(
                "client_eval is enabled but the round evaluated no client "
                "(wiring bug in the round function)"
            )
        accs = accs.cpu().numpy().astype(np.float64)
        get_logger().info(
            "round %d: pre-agg client acc mean=%.4f min=%.4f max=%.4f; "
            "post-agg global acc=%.4f",
            ctx.round_idx, accs.mean(), accs.min(), accs.max(),
            ctx.metrics["accuracy"],
        )
        return {
            "client_eval": {
                "pre_agg_accuracy_mean": float(accs.mean()),
                "pre_agg_accuracy_min": float(accs.min()),
                "pre_agg_accuracy_max": float(accs.max()),
                "post_agg_accuracy": float(ctx.metrics["accuracy"]),
            }
        }

    def make_server_update(self):
        """Optional server-side optimizer step on the round aggregate:
        ``(init_fn, update_fn)``, or None (plain FedAvg: the aggregate is
        the next global model).

        The pseudo-gradient ``prev_global - aggregate`` takes an optimizer
        step: ``sgd`` with ``server_momentum`` is FedAvgM, ``adam`` FedAdam
        (sgd at lr 1 without momentum is FedAvg again). The arithmetic is
        the JAX package's jitted update on the f32 global model:
        ``trace = fma(trace, momentum, g)`` and ``params = fma(direction,
        -lr, prev)`` (parallel/engine.fma; Adam's direction as
        :class:`Adam` computes it). ``update_fn(prev, aggregate, state,
        rejected=None)``: a rejected round returns ``prev`` and ``state``
        unchanged, so momentum or Adam's moments from earlier rounds move
        nothing."""
        cfg = self.config
        name = cfg.server_optimizer_name.lower()
        if name in ("none", ""):
            return None
        lr = cfg.server_learning_rate
        if name == "sgd":
            momentum = cfg.server_momentum

            def init(params):
                # No momentum keeps an empty state (optax's EmptyState), so
                # that a checkpoint still records a server optimizer.
                return torch.zeros_like(params) if momentum else {}

            def direction(grads, state, params):
                if not momentum:
                    return grads, state
                trace = fma(state, momentum, grads)
                return trace, trace
        elif name == "adam":
            tx = Adam(lr, server=True)
            init, direction = tx.init, tx.direction
        else:  # validated by ExperimentConfig.validate
            raise ValueError(
                f"unknown server optimizer {name!r}; known: none, sgd, adam"
            )

        def update(prev_global, aggregate, opt_state, rejected=None):
            if rejected is not None and not isinstance(rejected,
                                                       torch.Tensor):
                if rejected:  # a host verdict
                    return prev_global, opt_state
                rejected = None
            pseudo_grad = prev_global - aggregate.to(prev_global.dtype)
            d, new_state = direction(pseudo_grad, opt_state, prev_global)
            stepped = fma(d, -lr, prev_global)
            if rejected is None:
                return stepped, new_state
            # A device verdict: selects, so the round never waits on it
            # (Adam's host step count alone needs the verdict on the host).
            return (_select(rejected, prev_global, stepped),
                    _select(rejected, opt_state, new_state))

        return init, update
