"""FedAvg: dataset-size-weighted federated averaging (algorithms/fedavg.py of
the JAX package, main branch: full participation, ``mean`` aggregation).

One round: every client trains from the global model, and each client's
params are added, with weight ``w_k = size_k / sum(sizes)``, into an f32
aggregate (f32 even when the client params are bf16). The clients run one
after another in the order the JAX fused path reduces them:

* without the size-aware schedule, chunks of ``client_chunk_size`` clients
  in client order (the last chunk may be a remainder);
* with it (``bucket_client_work``, on by default), the ``_bucket_plan``
  groups in descending step count, each group chunked the same way; a
  client in a group with ``s`` steps trains on its first ``s * batch_size``
  slots, so its epoch permutations run over that many slots. Empty clients
  are skipped.

Each chunk's weighted sum is accumulated separately and added into its
group's, and the groups into the aggregate, as the JAX program adds its
partial sums. A round whose total weight is 0 keeps the previous global
model.

Template hooks for subclasses (fed_quant): ``client_param_transform``
(applied to the params inside the loss and in client eval),
``process_client_payload`` (each client's upload, before it is weighted)
and ``process_aggregated`` (the broadcast). The JAX hooks take PRNG keys;
here they take per-leaf 32-bit salts, which the round draws from its
generator or takes from ``payload_salts`` (tests pass the JAX package's).

``client_eval`` (auto: on for fed_quant at cohorts <= 32): each client's
raw model, cast to f32, is evaluated through the transform right after it
trains, before its payload is processed, and post_round reports the
``client_eval`` record sub-object. As in the JAX package (whose client eval
runs on its materializing path) this trains every client, with no size-
aware schedule.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_learning_simulator_tpu_torch.algorithms.base import Algorithm
from distributed_learning_simulator_tpu_torch.ops.quantize import Segments
from distributed_learning_simulator_tpu_torch.parallel.engine import (
    draw_client_rng,
    make_local_train_fn,
)
from distributed_learning_simulator_tpu_torch.utils.logging import get_logger


class FedAvg(Algorithm):
    name = "fed"
    #: Whether the payload hooks use salts (the round draws them only then).
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

    def prepare(self, apply_fn, eval_fn, eval_batches=None):
        self._eval_fn = eval_fn
        self._eval_batches = eval_batches

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
            and not client_eval
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

        def schedule(shard_size: int):
            """[(slots, [chunk of client ids, ...]), ...] in reduction
            order."""
            plan = None
            if bucket_sizes is not None:
                plan = _bucket_plan(shard_size // bsz)
                if len(plan) <= 1:
                    plan = None  # uniform work: the plain path
            if plan is None:
                groups = [(shard_size, np.arange(n_clients))]
            else:
                groups = [(s * bsz, idx) for s, idx in
                          sorted(plan.items(), reverse=True) if s > 0]
            out = []
            for slots, idx in groups:
                if chunk is None or chunk >= idx.size:
                    chunks = [idx]
                else:
                    chunks = [idx[i:i + chunk]
                              for i in range(0, idx.size, chunk)]
                out.append((slots, [[int(c) for c in ch] for ch in chunks]))
            return out

        def round_fn(global_flat, client_state, cx, cy, cmask, sizes,
                     generator, lr_scale=1.0, client_rng=None,
                     payload_salts=None):
            """``sizes`` is the host f32 ``[n_clients]`` weight vector;
            ``client_state`` is None (nothing persists across rounds).
            ``client_rng(client, n_slots) -> (epoch_perms, sr_salt)`` and
            ``payload_salts(client) -> [n_leaves] salts`` (``client=None``:
            the broadcast's) optionally replace the generator's draws (tests
            pass the JAX package's); by default each trained client draws
            from ``generator`` in client order, then the payload salts."""
            plan = schedule(cx.shape[1])
            trained = sorted(i for _, chunks in plan for ch in chunks
                             for i in ch)
            if client_rng is None:
                slots_of = {i: slots for slots, chunks in plan
                            for ch in chunks for i in ch}
                draws = {
                    i: draw_client_rng(generator, slots_of[i], cfg.epoch)
                    for i in trained
                }

                def client_rng(i, n_slots):
                    return draws[i]
            if payload_salts is None and self.payload_salted:
                salt_draws = {
                    i: torch.randint(0, 2**32, (n_leaves,),
                                     generator=generator)
                    for i in trained + [None]
                }
                payload_salts = salt_draws.__getitem__
            elif payload_salts is None:
                def payload_salts(i):
                    return None
            sizes = np.asarray(sizes, dtype=np.float32)
            total = sizes.sum(dtype=np.float32)
            norm_w = sizes / np.maximum(total, np.float32(1e-12))
            losses = torch.zeros(n_clients, device=global_flat.device)
            accs = torch.zeros_like(losses)
            eval_accs = torch.zeros_like(losses) if client_eval else None
            agg = torch.zeros_like(global_flat, dtype=torch.float32)
            for slots, chunks in plan:
                group_acc = torch.zeros_like(agg)
                for members in chunks:
                    chunk_acc = torch.zeros_like(agg)
                    for i in members:
                        perms, salt = client_rng(i, slots)
                        params, metrics = local_train(
                            global_flat, cx[i, :slots], cy[i, :slots],
                            cmask[i, :slots], perms, salt, lr_scale,
                        )
                        if client_eval:
                            # As the JAX package's materializing path: the
                            # client's params in f32, then evaluated.
                            params = params.float()
                            eval_accs[i] = evaluate_client(params)
                        params, _ = self.process_client_payload(
                            params, payload_salts(i)
                        )
                        chunk_acc.add_(params.float(), alpha=float(norm_w[i]))
                        losses[i] = metrics["loss"]
                        accs[i] = metrics["accuracy"]
                    group_acc += chunk_acc
                agg += group_acc
            # Empty effective cohort: keep the previous global model.
            new_global = agg if total > 0 else global_flat
            new_global, agg_aux = self.process_aggregated(
                new_global, payload_salts(None)
            )
            aux = {
                "client_loss": losses,
                "client_accuracy": accs,
                "mean_client_loss": losses.mean(),
                **agg_aux,
            }
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
