"""SignSGD with majority vote: per-step synchronized 1-bit SGD
(algorithms/sign_sgd.py of the JAX package).

Every optimizer step, each client computes its gradient at the ONE shared
params (all clients apply the same voted update, so they always hold the
same params), turns it into its torch-SGD update direction (momentum,
dampening, nesterov), and signs it. The signs are summed over the clients
in f32, re-signed (the majority vote), and applied with weight decay:
``p <- p - lr * (voted + wd * p)``. As in the JAX package, each step takes
the clients a chunk of ``client_chunk_size`` at a time (all at once
without a chunk size): one ``torch.func.vmap`` of the gradient over the
chunk's batches at the shared params, then the chunk's momenta, directions
and signs as ops on its ``[M, P]`` stack, and its partial sign sum added
to the vote. The sum of +-1/0 terms is exact in any order, so the
chunking changes nothing but memory.

Per-client momentum buffers and step counters persist across rounds as the
algorithm's client state: a flat ``[n_clients, P]`` tensor, allocated only
when momentum != 0 (torch allocates no buffer at momentum 0). The port
updates each chunk's rows in place (the JAX program returns a new stack);
the round returns the same state object.

Each epoch's batch order is one permutation per client, drawn as the JAX
package draws them from the round key (ops/prng.py): client c's order in
epoch e is ``permutation(split(split(key, epochs)[e], n_clients)[c],
shard)``. Each step gathers every client's own minibatch rows
(ops/cohort.py ``batched_take``). The SGD optimizer is required, as in the
reference.

With a failure model (dropout or straggler; the corrupt modes are
refused, a 1-bit vote has no parameter payload to corrupt) the round's
first key split draws which clients fail: a failed client's votes are left
out of every step (the majority counts the survivors), and its momentum
and step count stay as they were. The quorum guard rejects a round whose
survivors fall below ``min_survivors`` or whose voted params are not
finite, returning the round-start params.

With ``client_stats='on'`` the round reports ``aux["vote_agreement"]``: the
shared params leave no per-client update to score, so the round statistic
is the majority vote's mean agreement, ``1/2 + mean|vote| / (2 V)`` over
the P coordinates for V voters, averaged over steps and epochs (1.0: a
unanimous step; 0.5: coin-flip directions). A pure read of the vote.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_learning_simulator_tpu_torch.algorithms.base import Algorithm
from distributed_learning_simulator_tpu_torch.ops import prng
from distributed_learning_simulator_tpu_torch.ops.cohort import (
    batched_take,
    to_device,
)
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
    chunk_decoder,
    make_loss_fn,
)
from distributed_learning_simulator_tpu_torch.robustness.faults import (
    FailureModel,
    finite_flag,
)
from distributed_learning_simulator_tpu_torch.telemetry.client_stats import (
    ClientStats,
)
from distributed_learning_simulator_tpu_torch.utils.tracing import (
    profile_step,
)


class SignSGD(Algorithm):
    name = "sign_SGD"
    supports_round_batching = True
    #: Each step's vote takes every client (the constructor refuses
    #: participation_fraction < 1), so under streamed residency the cohort
    #: is the population: one upload at the start.
    supports_streamed_residency = True

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
        if FailureModel.from_config(config) is not None and (
            config.failure_mode in ("corrupt_nan", "corrupt_scale")
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
        chunk = cfg.client_chunk_size or n_clients
        loss_fn = make_loss_fn(lambda flat, x: apply_fn(layout.unflatten(flat),
                                                        x))
        # The chunk's gradients at the ONE shared params (JAX: vmap of the
        # grad with in_axes=(None, 0, 0, 0)).
        grad_fn = torch.func.vmap(
            torch.func.grad_and_value(loss_fn, has_aux=True),
            in_dims=(None, 0, 0, 0))
        decode = chunk_decoder(preprocess) if preprocess is not None else None
        # Failure model (dropout/straggler; the constructor refuses the
        # corrupt modes), drawn once a round: a failed client misses the
        # whole round, its votes are left out (the majority counts the
        # survivors), and its momentum and step count freeze.
        fm = FailureModel.from_config(cfg)
        min_survivors = cfg.min_survivors
        quorum = fm is not None or min_survivors > 0
        cs = ClientStats.from_config(cfg)

        def round_fn(global_flat, client_state, cx, cy, cmask, sizes,
                     key, lr_scale=1.0, client_rng=None,
                     payload_salts=None):
            """``key`` is the round key; ``client_rng(client, n_slots) ->
            (epoch_perms, _)`` optionally replaces its draws. ``sizes``
            (the vote is unweighted), ``lr_scale`` (config.py refuses lr
            schedules for sign_SGD) and ``payload_salts`` are not read."""
            shard = cx.shape[1]
            steps = shard // bsz
            surv = None
            if fm is not None:
                key, fault_key = prng.split(key)
                failed = fm.draw_failed(fault_key, n_clients)
                n_surv = int((~failed).sum())
                surv = to_device(~failed, global_flat.device, torch.float32)
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
            epoch_agree = []
            for e in range(epochs):
                perms = to_device(torch.stack([p[e] for p in client_perms]),
                                  cx.device)
                step_losses, step_agree = [], []
                for step in range(steps):
                    idx = perms[:, step * bsz:(step + 1) * bsz]  # [C, B]
                    bx = batched_take(cx, idx)
                    by = batched_take(cy, idx)
                    bm = batched_take(cmask, idx)
                    is_first = step_counts == 0
                    vote = torch.zeros_like(params, dtype=torch.float32)
                    loss_sum = torch.zeros((), dtype=torch.float32,
                                           device=params.device)
                    for c0 in range(0, n_clients, chunk):
                        rows = slice(c0, c0 + chunk)
                        xb = bx[rows] if decode is None else decode(bx[rows])
                        grads, (losses, _) = grad_fn(params, xb, by[rows],
                                                     bm[rows])
                        with torch.no_grad():
                            direction = grads
                            if has_momentum:
                                m_new = momentum_leaf(
                                    momenta[rows], grads,
                                    is_first[rows, None], mu, dampening,
                                )
                                direction = direction_leaf(grads, m_new, mu,
                                                           nesterov)
                            signs = torch.sign(direction)
                            if surv is not None:
                                s_c = surv[rows]
                                signs = signs * s_c[:, None]
                                losses = losses * s_c
                                if has_momentum:
                                    m_new = torch.where(s_c[:, None] > 0,
                                                        m_new, momenta[rows])
                            if has_momentum:
                                momenta[rows] = m_new
                            vote += signs.sum(dim=0)
                            loss_sum += losses.sum()
                    with torch.no_grad():
                        if surv is None or n_surv > 0:
                            # No survivor, no step (not even weight decay).
                            params = vote_apply_leaf(
                                params, torch.sign(vote), lr, wd)
                    if surv is None:
                        step_counts = step_counts + 1
                        denom = n_clients
                    else:
                        step_counts = step_counts + surv.to(torch.int32)
                        denom = float(max(n_surv, 1))
                    step_losses.append(loss_sum / denom)
                    if cs is not None:
                        step_agree.append(
                            0.5 + vote.abs().sum() / (2.0 * denom
                                                      * vote.numel()))
                    profile_step()
                epoch_loss = torch.stack(step_losses).mean()
                if cs is not None:
                    epoch_agree.append(torch.stack(step_agree).mean())
            aux = {
                "mean_client_loss": epoch_loss,
                "sync_steps": epochs * steps,
            }
            if cs is not None:
                aux["vote_agreement"] = torch.stack(epoch_agree).mean()
            if quorum:
                # Reject the round (back to the round-start params) when
                # the survivors fall below min_survivors or the voted
                # params are not finite. The per-client momentum and step
                # state keeps its per-client freeze.
                survivor_count = n_surv if fm is not None else n_clients
                # A select on the device: the round never waits to decide.
                rejected = (~finite_flag(params)
                            | bool(survivor_count < min_survivors))
                params = torch.where(rejected, global_flat.to(params.dtype),
                                     params)
                aux["survivor_count"] = survivor_count
                aux["round_rejected"] = rejected
            new_state = (
                {"momenta": momenta, "steps": step_counts}
                if has_momentum else None
            )
            return params, new_state, aux

        # Streamed or not, the cohort is everyone: the resident program
        # runs on the population's arrays, uploaded once.
        return round_fn

    def post_round(self, ctx):
        raw = payload_bytes(ctx.layout)
        signed = sign_payload_bytes(ctx.layout)
        return {
            "uplink_compression_ratio": compression_ratio(raw, signed),
            "payload_bytes_sign": signed,
        }
