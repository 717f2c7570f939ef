"""FedAvg: dataset-size-weighted federated averaging (algorithms/fedavg.py of
the JAX package).

One round: the cohort trains from the global model, and the server combines
the uploads. The round takes the round key of the JAX package's key chain
and derives every draw from it as the JAX program does (ops/prng.py):
``round_key_splits`` gives ``(part_key, train_key, payload_key, agg_key)``;
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
  clients run one after another in the order the JAX fused path reduces
  them: without the size-aware schedule, chunks of ``client_chunk_size``
  cohort positions in order (the last chunk may be a remainder); with it
  (``bucket_client_work``, full participation only), the ``_bucket_plan``
  groups in descending step count, each group chunked the same way; a
  client in a group with ``s`` steps trains on its first ``s * batch_size``
  slots, so its epoch permutations run over that many slots. Empty clients
  are skipped. Each chunk's weighted sum is accumulated separately and
  added into its group's, and the groups into the aggregate, as the JAX
  program adds its partial sums.
* **The materializing path** (``materializes_client_stack``: a robust rule,
  ``client_eval``, or ``keep_client_params``): every cohort client trains
  on its whole shard, and its processed upload, in f32, becomes row p of a
  ``[cohort, P]`` stack; ``ops/aggregate.aggregate`` combines the stack by
  ``config.aggregation``. A robust rule whose result is not finite keeps the
  previous global model. With ``keep_client_params`` (the Shapley
  algorithms) the stack is ``aux["client_params"]``.

A round whose cohort weight is 0 keeps the previous global model.

Template hooks for subclasses (fed_quant): ``client_param_transform``
(applied to the params inside the loss and in client eval),
``process_client_payload`` (each client's upload, before it is weighted)
and ``process_aggregated`` (the broadcast). The JAX hooks take PRNG keys;
here they take per-leaf 32-bit salts, which the round derives from the
payload keys exactly as the JAX hooks fold theirs: per chunk of the
reduction order (or the whole cohort on the materializing path) a key is
split into one key per client, and each client's into one salt per leaf.

``client_eval`` (auto: on for fed_quant at cohorts <= 32): each client's
raw model, cast to f32, is evaluated through the transform right after it
trains, before its payload is processed, and post_round reports the
``client_eval`` record sub-object.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_learning_simulator_tpu_torch.algorithms.base import Algorithm
from distributed_learning_simulator_tpu_torch.ops import prng
from distributed_learning_simulator_tpu_torch.ops.aggregate import aggregate
from distributed_learning_simulator_tpu_torch.ops.quantize import Segments
from distributed_learning_simulator_tpu_torch.ops.sampling import (
    draw_cohort_host,
)
from distributed_learning_simulator_tpu_torch.parallel.engine import (
    client_draws,
    make_local_train_fn,
)
from distributed_learning_simulator_tpu_torch.utils.logging import get_logger


def round_key_splits(key):
    """The round key's split chain, as the JAX package's
    ``round_key_splits(key, with_faults=False)``: ``(part_key, train_key,
    payload_key, agg_key)``. (Its 5-way split with a fault key comes with
    the failure models, ROADMAP.md queue 1 item 12.)"""
    part_key, train_key, payload_key, agg_key = prng.split(key, 4)
    return part_key, train_key, payload_key, agg_key


def chunk_keys(group_key, n_members: int, chunk: int | None):
    """The per-chunk payload keys of one reduction group, as the JAX
    package's fused path takes them: the group's own key when it is one
    chunk, else ``split(group_key, n_full_chunks + 1)`` with chunk j taking
    key j (a remainder chunk takes the last)."""
    if chunk is None or chunk <= 0 or n_members <= chunk:
        return [group_key]
    return list(prng.split(group_key, n_members // chunk + 1))


class FedAvg(Algorithm):
    name = "fed"
    #: Whether the payload hooks use salts (the round derives them only then).
    payload_salted = False

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

    def prepare(self, apply_fn, eval_fn, eval_batches=None):
        self._eval_fn = eval_fn
        self._eval_batches = eval_batches

    def cohort_indices(self, round_key, n_clients: int):
        """The round's cohort (true client ids) as ``make_round_fn``'s round
        draws it from ``round_key``; None under full participation."""
        cfg = self.config
        n_participants = cfg.cohort_size(n_clients)
        if n_participants == n_clients:
            return None
        return draw_cohort_host(
            round_key_splits(round_key)[0], n_clients, n_participants,
            cfg.participation_sampler.lower(),
        )

    # Template hooks (identity here; fed_quant overrides them). The payload
    # hooks return (value, extra_aux).
    def client_param_transform(self):
        """Flat -> flat transform applied to the params inside the loss and
        in client eval; None for none."""
        return None

    def process_client_payload(self, client_params, salts):
        return client_params, {}

    def process_aggregated(self, global_params, salts):
        return global_params, {}

    def make_round_fn(self, apply_fn, optimizer, layout, n_clients: int,
                      preprocess=None, client_sizes=None, device=None):
        self.check_cohort(n_clients)
        cfg = self.config
        bsz = cfg.batch_size
        chunk = cfg.client_chunk_size
        compute_dtype = (
            torch.bfloat16 if cfg.local_compute_dtype == "bfloat16" else None
        )
        self.segments = Segments(layout.numels, device)
        transform = self.client_param_transform()
        client_eval = self._client_eval_enabled
        materialize = self.materializes_client_stack
        keep_stack = bool(self.keep_client_params)
        aggregation = cfg.aggregation.lower()
        n_participants = cfg.cohort_size(n_clients)
        sampled = n_participants < n_clients
        if client_eval and self._eval_fn is None:
            raise RuntimeError(
                "client_eval needs prepare(apply_fn, eval_fn, eval_batches) "
                "before make_round_fn"
            )
        local_train = make_local_train_fn(
            apply_fn, optimizer, layout,
            local_epochs=cfg.epoch,
            batch_size=bsz,
            preprocess=preprocess,
            compute_dtype=compute_dtype,
            device=device,
            param_transform=transform,
        )
        n_leaves = len(layout.numels)

        def evaluate_client(params):
            with torch.no_grad():
                if transform is not None:
                    params = transform(params)
                return self._eval_fn(layout.unflatten(params),
                                     *self._eval_batches)["accuracy"]

        bucket_sizes = None
        if (
            client_sizes is not None
            and cfg.bucket_client_work
            and not materialize
            and not sampled
            and chunk is not None
            and chunk > 0
        ):
            bucket_sizes = np.asarray(client_sizes, dtype=np.int64)

        def _bucket_plan(total_steps: int):
            """{steps -> client indices}: clients sorted by needed step
            count, cut into chunks, chunks grouped by their largest
            member's steps; empty clients go to the s=0 group."""
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

        def schedule(shard_size: int, payload_key):
            """The reduction order: ``[(slots, [(chunk payload key, [cohort
            positions, ...]), ...]), ...]``. The group keys are the JAX
            program's: ``payload_key`` for the plain path, else one split
            per plan group (the s=0 group, last, trains nothing)."""
            plan = None
            if bucket_sizes is not None:
                plan = _bucket_plan(shard_size // bsz)
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
                    chunks = [idx[i:i + chunk]
                              for i in range(0, idx.size, chunk)]
                keys = chunk_keys(gk, idx.size, chunk)
                out.append((slots, [
                    (keys[j], [int(p) for p in ch])
                    for j, ch in enumerate(chunks)
                ]))
            return out

        def round_fn(global_flat, client_state, cx, cy, cmask, sizes, key,
                     lr_scale=1.0, client_rng=None, payload_salts=None):
            """``sizes`` is the host f32 ``[n_clients]`` weight vector,
            ``key`` the round key (ops/prng.py); ``client_state`` is None
            (nothing persists across rounds). ``client_rng(client,
            n_slots) -> (epoch_perms, sr_salt)`` and ``payload_salts(client)
            -> [n_leaves] salts`` (``client=None``: the broadcast's)
            optionally replace the key chain's draws (tests)."""
            _, train_key, payload_key, agg_key = round_key_splits(key)
            ids = self.cohort_indices(key, n_clients)
            if ids is None:
                ids = np.arange(n_clients)
            client_keys = prng.split(train_key, n_participants)
            pos_of = {int(i): p for p, i in enumerate(ids)}
            if materialize:
                plan = [(cx.shape[1], [(payload_key,
                                        list(range(n_participants)))])]
            else:
                plan = schedule(cx.shape[1], payload_key)
            if client_rng is None:
                def client_rng(i, n_slots):
                    return client_draws(client_keys[pos_of[i]], n_slots,
                                        cfg.epoch)
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
            part_sizes = np.asarray(sizes, dtype=np.float32)[ids]
            total = part_sizes.sum(dtype=np.float32)
            norm_w = part_sizes / np.maximum(total, np.float32(1e-12))
            losses = torch.zeros(n_participants, device=global_flat.device)
            accs = torch.zeros_like(losses)
            eval_accs = torch.zeros_like(losses) if client_eval else None

            def train(p, slots):
                i = int(ids[p])
                perms, salt = client_rng(i, slots)
                params, metrics = local_train(
                    global_flat, cx[i, :slots], cy[i, :slots],
                    cmask[i, :slots], perms, salt, lr_scale,
                )
                losses[p] = metrics["loss"]
                accs[p] = metrics["accuracy"]
                return params

            aux = {}
            if materialize:
                stack = torch.empty((n_participants,) + global_flat.shape,
                                    dtype=torch.float32,
                                    device=global_flat.device)
                for p in range(n_participants):
                    # f32, as the JAX package casts the stack for the rules.
                    params = train(p, cx.shape[1]).float()
                    if client_eval:
                        eval_accs[p] = evaluate_client(params)
                    stack[p], _ = self.process_client_payload(
                        params, payload_salts(int(ids[p]))
                    )
                new_global = aggregate(stack, part_sizes, aggregation,
                                       cfg.trim_ratio)
                if (aggregation != "mean"
                        and not bool(torch.isfinite(new_global).all())):
                    # Every candidate diverged: keep the previous model.
                    new_global = global_flat.to(new_global.dtype)
                if keep_stack:
                    aux["client_params"] = stack
            else:
                new_global = torch.zeros_like(global_flat,
                                              dtype=torch.float32)
                for slots, chunks in plan:
                    group_acc = torch.zeros_like(new_global)
                    for _, members in chunks:
                        chunk_acc = torch.zeros_like(new_global)
                        for p in members:
                            params, _ = self.process_client_payload(
                                train(p, slots), payload_salts(int(ids[p]))
                            )
                            chunk_acc.add_(params.float(),
                                           alpha=float(norm_w[p]))
                        group_acc += chunk_acc
                    new_global += group_acc
            # Empty effective cohort: keep the previous global model.
            if not total > 0:
                new_global = global_flat
            new_global, agg_aux = self.process_aggregated(
                new_global, payload_salts(None)
            )
            aux.update({
                "client_loss": losses,
                "client_accuracy": accs,
                "mean_client_loss": losses.mean(),
                **agg_aux,
            })
            if sampled:
                aux["participants"] = np.asarray(ids)
            if client_eval:
                aux["client_eval_accuracy"] = eval_accs
            return new_global, client_state, aux

        return round_fn

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
        if self.config.server_optimizer_name.lower() in ("none", ""):
            return None
        raise NotImplementedError(
            "server optimizers are not ported to the PyTorch package yet "
            "(ROADMAP.md queue 1 item 19)"
        )
