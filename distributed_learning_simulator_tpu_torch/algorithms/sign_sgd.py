"""SignSGD with majority vote: per-step synchronized 1-bit SGD
(algorithms/sign_sgd.py of the JAX package).

Every optimizer step, each client computes its gradient at the ONE shared
params (all clients apply the same voted update, so they always hold the
same params), turns it into its torch-SGD update direction (momentum,
dampening, nesterov), and signs it. The signs are summed over the clients
in f32, re-signed (the majority vote), and applied with weight decay:
``p <- p - lr * (voted + wd * p)``. The sum of +-1/0 terms is exact in any
order, so the JAX package's chunking of the client axis (a memory bound
for its vmapped gradients) changes nothing here: the port sums client by
client.

Per-client momentum buffers and step counters persist across rounds as the
algorithm's client state: a flat ``[n_clients, P]`` tensor, allocated only
when momentum != 0 (torch allocates no buffer at momentum 0). The port
updates each client's row in place (the JAX program returns a new stack);
the round returns the same state object.

Each epoch's batch order is one permutation per client, drawn as the JAX
package draws them from the round key (ops/prng.py): client c's order in
epoch e is ``permutation(split(split(key, epochs)[e], n_clients)[c],
shard)``. Each step gathers every client's own minibatch rows
(ops/cohort.py ``batched_take``). The SGD optimizer is required, as in the
reference.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_learning_simulator_tpu_torch.algorithms.base import Algorithm
from distributed_learning_simulator_tpu_torch.ops import prng
from distributed_learning_simulator_tpu_torch.ops.cohort import batched_take
from distributed_learning_simulator_tpu_torch.ops.payload import (
    compression_ratio,
    payload_bytes,
    sign_payload_bytes,
)
from distributed_learning_simulator_tpu_torch.ops.sign import (
    direction_leaf,
    momentum_leaf,
    vote_apply_leaf,
)
from distributed_learning_simulator_tpu_torch.parallel.engine import (
    make_loss_fn,
)


class SignSGD(Algorithm):
    name = "sign_SGD"

    def __init__(self, config):
        super().__init__(config)
        if config.optimizer_name.lower() != "sgd":
            raise ValueError(
                "sign_SGD requires the SGD optimizer "
                "(parity with reference sign_sgd_worker.py:14)"
            )
        if config.augment.lower() not in ("none", ""):
            raise ValueError(
                "sign_SGD does not support data augmentation; set "
                "augment='none'"
            )
        if config.aggregation.lower() != "mean":
            raise ValueError(
                "sign_SGD aggregates by sign majority vote; set "
                "aggregation='mean'"
            )
        if config.local_compute_dtype != "float32":
            raise ValueError(
                "sign_SGD does not use local_compute_dtype; set it to "
                "'float32'"
            )
        if config.participation_fraction < 1.0:
            raise ValueError(
                "sign_SGD votes over every client each step; "
                "participation_fraction < 1 is not supported"
            )
        if (
            config.failure_mode in ("corrupt_nan", "corrupt_scale")
            and config.failure_prob > 0.0
        ):
            raise ValueError(
                "sign_SGD supports failure_mode dropout/straggler only "
                "(its 1-bit vote has no parameter payload to corrupt); "
                f"got {config.failure_mode!r}"
            )

    def init_client_state(self, optimizer, global_flat, n_clients: int):
        """Per-client momentum buffers ``[n_clients, P]`` and step counters
        (the counter reproduces torch's first step, which sets the buffer to
        the raw gradient); None at momentum 0."""
        if self.config.momentum == 0.0:
            return None
        return {
            "momenta": torch.zeros((n_clients,) + tuple(global_flat.shape),
                                   dtype=global_flat.dtype,
                                   device=global_flat.device),
            "steps": torch.zeros(n_clients, dtype=torch.int32,
                                 device=global_flat.device),
        }

    def make_round_fn(self, apply_fn, optimizer, layout, n_clients: int,
                      preprocess=None, client_sizes=None, device=None):
        # client_sizes is unused: the vote synchronizes every client at
        # every step, so all clients run the same step count.
        cfg = self.config
        lr, mu, wd = cfg.learning_rate, cfg.momentum, cfg.weight_decay
        dampening, nesterov = cfg.dampening, cfg.nesterov
        bsz, epochs = cfg.batch_size, cfg.epoch
        has_momentum = mu != 0.0
        loss_fn = make_loss_fn(lambda flat, x: apply_fn(layout.unflatten(flat),
                                                        x))

        def round_fn(global_flat, client_state, cx, cy, cmask, sizes,
                     key, lr_scale=1.0, client_rng=None,
                     payload_salts=None):
            """``key`` is the round key; ``client_rng(client, n_slots) ->
            (epoch_perms, _)`` optionally replaces its draws. ``sizes``
            (the vote is unweighted), ``lr_scale`` (config.py refuses lr
            schedules for sign_SGD) and ``payload_salts`` are not read."""
            shard = cx.shape[1]
            steps = shard // bsz
            if client_rng is None:
                perm_keys = [prng.split(ek, n_clients)
                             for ek in prng.split(key, epochs)]

                def client_rng(i, n_slots):
                    return [
                        torch.from_numpy(
                            prng.permutation(ks[i], n_slots).astype(np.int64)
                        )
                        for ks in perm_keys
                    ], 0
            client_perms = [client_rng(i, shard)[0] for i in range(n_clients)]
            params = global_flat
            if has_momentum:
                momenta = client_state["momenta"]
                step_counts = client_state["steps"]
            else:
                momenta = None
                step_counts = torch.zeros(n_clients, dtype=torch.int32,
                                          device=global_flat.device)
            epoch_loss = None
            for e in range(epochs):
                perms = torch.stack([p[e] for p in client_perms]).to(cx.device)
                step_losses = []
                for step in range(steps):
                    idx = perms[:, step * bsz:(step + 1) * bsz]  # [C, B]
                    bx = batched_take(cx, idx)
                    by = batched_take(cy, idx)
                    bm = batched_take(cmask, idx)
                    is_first = step_counts == 0
                    p = params.detach().requires_grad_(True)
                    vote = torch.zeros_like(params, dtype=torch.float32)
                    loss_sum = torch.zeros((), dtype=torch.float32,
                                           device=params.device)
                    for i in range(n_clients):
                        xb = bx[i] if preprocess is None else preprocess(bx[i])
                        loss, _ = loss_fn(p, xb, by[i], bm[i])
                        (grad,) = torch.autograd.grad(loss, p)
                        with torch.no_grad():
                            direction = grad
                            if has_momentum:
                                m_new = momentum_leaf(
                                    momenta[i], grad, is_first[i], mu,
                                    dampening,
                                )
                                momenta[i] = m_new
                                direction = direction_leaf(grad, m_new, mu,
                                                           nesterov)
                            vote += torch.sign(direction)
                            loss_sum += loss.detach()
                    with torch.no_grad():
                        params = vote_apply_leaf(params, torch.sign(vote), lr,
                                                 wd)
                    step_counts = step_counts + 1
                    step_losses.append(loss_sum / n_clients)
                epoch_loss = torch.stack(step_losses).mean()
            aux = {
                "mean_client_loss": epoch_loss,
                "sync_steps": epochs * steps,
            }
            new_state = (
                {"momenta": momenta, "steps": step_counts}
                if has_momentum else None
            )
            return params, new_state, aux

        return round_fn

    def post_round(self, ctx):
        raw = payload_bytes(ctx.layout)
        signed = sign_payload_bytes(ctx.layout)
        return {
            "uplink_compression_ratio": compression_ratio(raw, signed),
            "payload_bytes_sign": signed,
        }
