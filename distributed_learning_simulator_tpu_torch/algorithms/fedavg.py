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
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_learning_simulator_tpu_torch.algorithms.base import Algorithm
from distributed_learning_simulator_tpu_torch.parallel.engine import (
    draw_client_rng,
    make_local_train_fn,
)


class FedAvg(Algorithm):
    name = "fed"

    # Template hooks (identity here; fed_quant overrides them in the JAX
    # package). Each returns (value, extra_aux).
    def process_client_payload(self, client_params):
        return client_params, {}

    def process_aggregated(self, global_params):
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
        local_train = make_local_train_fn(
            apply_fn, optimizer, layout,
            local_epochs=cfg.epoch,
            batch_size=bsz,
            preprocess=preprocess,
            compute_dtype=compute_dtype,
            device=device,
        )
        bucket_sizes = None
        if (
            client_sizes is not None
            and cfg.bucket_client_work
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

        def round_fn(global_flat, cx, cy, cmask, sizes, generator,
                     lr_scale=1.0, client_rng=None):
            """``sizes`` is the host f32 ``[n_clients]`` weight vector.
            ``client_rng(client, n_slots) -> (epoch_perms, sr_salt)``
            optionally replaces the generator's draws (tests pass the JAX
            package's); by default each trained client draws from
            ``generator`` in client order."""
            plan = schedule(cx.shape[1])
            if client_rng is None:
                slots_of = {i: slots for slots, chunks in plan
                            for ch in chunks for i in ch}
                draws = {
                    i: draw_client_rng(generator, slots_of[i], cfg.epoch)
                    for i in sorted(slots_of)
                }

                def client_rng(i, n_slots):
                    return draws[i]
            sizes = np.asarray(sizes, dtype=np.float32)
            total = sizes.sum(dtype=np.float32)
            norm_w = sizes / np.maximum(total, np.float32(1e-12))
            losses = torch.zeros(n_clients, device=global_flat.device)
            accs = torch.zeros_like(losses)
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
                        params, _ = self.process_client_payload(params)
                        chunk_acc.add_(params.float(), alpha=float(norm_w[i]))
                        losses[i] = metrics["loss"]
                        accs[i] = metrics["accuracy"]
                    group_acc += chunk_acc
                agg += group_acc
            # Empty effective cohort: keep the previous global model.
            new_global = agg if total > 0 else global_flat
            new_global, agg_aux = self.process_aggregated(new_global)
            aux = {
                "client_loss": losses,
                "client_accuracy": accs,
                "mean_client_loss": losses.mean(),
                **agg_aux,
            }
            return new_global, aux

        return round_fn

    def make_server_update(self):
        if self.config.server_optimizer_name.lower() in ("none", ""):
            return None
        raise NotImplementedError(
            "server optimizers are not ported to the PyTorch package yet "
            "(ROADMAP.md queue 1 item 19)"
        )
