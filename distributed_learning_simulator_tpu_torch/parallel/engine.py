"""Local training of one client, and server evaluation (parallel/engine.py
of the JAX package).

Each model is one flat tensor (models/registry.py ``ParamLayout``): the f32
global model, a client's local copy, its gradient and its momentum trace.
So the optimizer step, the bf16 stochastic rounding and the aggregation are
a handful of flat tensor ops, whatever the number of parameter leaves.

The JAX package vmaps ``local_train`` over the client axis. Here the client
axis is written out: the round (algorithms/fedavg.py) calls ``local_train``
once per client. Its randomness — each epoch's batch order and the bf16
rounding salt — comes from the client's key of the JAX package's key chain
(:func:`client_draws`, ops/prng.py), so it is the reference's bit for bit,
or is handed in by the caller.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from distributed_learning_simulator_tpu_torch.ops import prng
from distributed_learning_simulator_tpu_torch.ops.quantize import (
    MASK32,
    Segments,
    hash_mix,
)

#: Salt advance per rounded leaf (the JAX package's ``0x9E3779B9``).
SALT_STEP = 0x9E3779B9


class SGD:
    """optax's ``chain(add_decayed_weights(wd), sgd(lr, momentum))`` on flat
    tensors: ``g += wd * p``; ``trace = g + momentum * trace``;
    ``update = -lr * trace``. The trace is kept in the params' dtype (optax's
    ``accumulator_dtype=None``); ``momentum == 0`` keeps no trace."""

    def __init__(self, learning_rate: float, momentum: float = 0.0,
                 weight_decay: float = 0.0):
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.weight_decay = weight_decay

    def init(self, params: torch.Tensor):
        return torch.zeros_like(params) if self.momentum else None

    def update(self, grads, state, params):
        updates = grads
        if self.weight_decay:
            updates = updates + self.weight_decay * params
        if self.momentum:
            updates = updates + self.momentum * state
            state = updates
        return updates * -self.learning_rate, state


def make_optimizer(name: str, learning_rate: float, momentum: float = 0.0,
                   weight_decay: float = 0.0) -> SGD:
    """Optimizer registry (sgd only in this port so far)."""
    if name.lower() != "sgd":
        raise NotImplementedError(
            f"optimizer {name!r} is not ported to the PyTorch package yet "
            "(ROADMAP.md queue 1 item 19)"
        )
    return SGD(learning_rate, momentum, weight_decay)


def make_loss_fn(apply_fn: Callable, param_transform: Callable | None = None):
    """Masked softmax cross-entropy + accuracy:
    ``loss_fn(params, x, y, mask) -> (loss, acc)``.

    ``param_transform`` hooks QAT: fed_quant's straight-through fake-quant
    applied to the params inside the loss (JAX ``make_loss_fn``)."""

    def loss_fn(params, x, y, mask):
        if param_transform is not None:
            params = param_transform(params)
        logits = apply_fn(params, x).float()
        nll = F.cross_entropy(logits, y, reduction="none")
        denom = torch.clamp(mask.sum(), min=1.0)
        loss = (nll * mask).sum() / denom
        acc = ((logits.argmax(dim=1) == y).float() * mask).sum() / denom
        return loss, acc

    return loss_fn


def make_decoder(sample_shape):
    """Batch decoder for compact (uint8-flattened) client storage: cast,
    rescale to [0, 1], restore the sample shape."""

    def decode(b):
        return (b.float() / 255.0).reshape((b.shape[0],) + tuple(sample_shape))

    return decode


def _sr_to_bf16(x32: torch.Tensor, salt):
    """Stochastically round f32 ``x32`` to bf16 (hash dither).

    bf16 keeps the top 16 bits of the f32 pattern; adding the hash's low 16
    bits below the cut before truncating rounds up with probability equal
    to the truncated fraction. ``salt`` is an int, or an int64 tensor of
    per-element salts. Returns ``(bf16 tensor, salt + 0x9E3779B9)``; the
    result is bit-identical to the JAX package's ``_sr_to_bf16``."""
    u = x32.contiguous().view(torch.int32).to(torch.int64) & MASK32
    h = hash_mix(u, salt)
    hi = ((u + (h & 0xFFFF)) >> 16) & 0xFFFF
    hi = torch.where(hi >= 0x8000, hi - 0x10000, hi).to(torch.int16)
    return hi.view(torch.bfloat16), (salt + SALT_STEP) & MASK32


def _sr_tree_to_bf16(leaves, salt: int):
    """Round every leaf in order, advancing the salt once per leaf.
    Returns ``(list of bf16 leaves, salt)``."""
    out = []
    for x in leaves:
        r, salt = _sr_to_bf16(x.float(), salt)
        out.append(r)
    return out, salt


class FlatRounder:
    """``_sr_tree_to_bf16`` over a flat parameter vector in one pass: the
    per-element salt is ``salt + leaf_index * 0x9E3779B9`` (leaves in the
    layout's order, the JAX tree's leaf order), and the salt advances by one
    step per leaf, exactly as the leaf-by-leaf loop would."""

    def __init__(self, layout, device):
        self.n_leaves = len(layout.names)
        steps = torch.arange(self.n_leaves, device=device) * SALT_STEP
        self.offsets = Segments(layout.numels, device).spread(steps & MASK32)

    def __call__(self, flat32: torch.Tensor, salt: int):
        rounded, _ = _sr_to_bf16(flat32, (self.offsets + salt) & MASK32)
        return rounded, (salt + self.n_leaves * SALT_STEP) & MASK32


def client_draws(client_key, n_slots: int, epochs: int):
    """One client's randomness for one round, from its training key as the
    JAX package's ``local_train`` derives it: the bf16 rounding salt is the
    first word of ``fold_in(key, 7)``, and epoch e's batch order is
    ``permutation(split(key, epochs)[e], n_slots)``. Returns ``(epoch_perms,
    sr_salt)``."""
    salt = int(prng.fold_in(client_key, 7)[0])
    perms = [torch.from_numpy(prng.permutation(k, n_slots).astype(np.int64))
             for k in prng.split(client_key, epochs)]
    return perms, salt


def make_local_train_fn(
    apply_fn: Callable,
    optimizer: SGD,
    layout,
    local_epochs: int,
    batch_size: int,
    preprocess: Callable | None = None,
    compute_dtype: torch.dtype | None = None,
    device=None,
    param_transform: Callable | None = None,
):
    """Build ``local_train(global_flat, xs, ys, mask, epoch_perms, sr_salt,
    lr_scale=1.0) -> (params_flat, metrics)``.

    E epochs over the client's ``n_slots = xs.shape[0]`` slots, one batch
    order per epoch (``epoch_perms[e]``, a permutation of the slots), batches
    of ``batch_size``. A fully masked batch is still an optimizer step, as in
    the JAX scan. ``metrics`` holds the last epoch's mean batch loss and
    accuracy as device scalars.

    ``compute_dtype=torch.bfloat16``: the client's params, grads and
    momentum live in bf16 for the local run. The f32 global model is cast
    with stochastic rounding salted by ``sr_salt``, and every step adds the
    update to the params in f32 and rounds stochastically into bf16
    storage.

    The optimizer starts fresh every round (``reset_client_optimizer``;
    persistent per-client optimizer state is not ported, config.py
    refuses it).

    ``param_transform`` (flat -> flat, e.g. fed_quant's fake-quant) is
    applied to the params inside the loss.
    """
    loss_fn = make_loss_fn(
        lambda flat, x: apply_fn(layout.unflatten(flat), x), param_transform
    )
    sr_enabled = compute_dtype == torch.bfloat16
    rounder = FlatRounder(layout, device) if sr_enabled else None

    def local_train(global_flat, xs, ys, mask, epoch_perms, sr_salt,
                    lr_scale=1.0):
        salt = sr_salt
        params = global_flat  # never written in place
        with torch.no_grad():
            if sr_enabled:
                params, salt = rounder(global_flat, salt)
            opt_state = optimizer.init(params)
        steps = xs.shape[0] // batch_size
        epoch_loss = epoch_acc = None
        for perm in epoch_perms:
            perm = perm.to(xs.device)
            losses, accs = [], []
            for step in range(steps):
                idx = perm[step * batch_size:(step + 1) * batch_size]
                bx, by, bm = xs[idx], ys[idx], mask[idx]
                if preprocess is not None:
                    bx = preprocess(bx)
                p = params.detach().requires_grad_(True)
                loss, acc = loss_fn(p, bx, by, bm)
                (grads,) = torch.autograd.grad(loss, p)
                with torch.no_grad():
                    updates, opt_state = optimizer.update(
                        grads, opt_state, params
                    )
                    if lr_scale != 1.0:
                        # f32 math, original dtype kept (JAX: the round
                        # schedule factor multiplies the final update).
                        updates = (updates.float() * lr_scale).to(
                            updates.dtype
                        )
                    if sr_enabled:
                        params, salt = rounder(
                            params.float() + updates.float(), salt
                        )
                    else:
                        params = params + updates
                losses.append(loss.detach())
                accs.append(acc.detach())
            epoch_loss = torch.stack(losses).mean()
            epoch_acc = torch.stack(accs).mean()
        return params, {"loss": epoch_loss, "accuracy": epoch_acc}

    return local_train


def pad_eval_set(x, y, batch_size: int, flatten: bool = False):
    """Host-side: pad + reshape a test set to ``[n_batches, batch_size,
    ...]`` with a mask (same arrays as the JAX package's)."""
    n = x.shape[0]
    if flatten:
        x = x.reshape(n, -1)
    n_batches = (n + batch_size - 1) // batch_size
    padded = n_batches * batch_size
    xp = np.zeros((padded,) + x.shape[1:], dtype=x.dtype)
    yp = np.zeros((padded,), dtype=np.int32)
    mp = np.zeros((padded,), dtype=np.float32)
    xp[:n], yp[:n], mp[:n] = x, y, 1.0
    return (
        xp.reshape((n_batches, batch_size) + x.shape[1:]),
        yp.reshape((n_batches, batch_size)),
        mp.reshape((n_batches, batch_size)),
    )


def make_eval_fn(apply_fn: Callable, preprocess: Callable | None = None):
    """Build ``evaluate(params, xb, yb, mb) -> {"loss", "accuracy"}`` over
    pre-padded batches ``[n_batches, batch_size, ...]``; the sums are f32
    device scalars, fetched by the caller once."""

    @torch.no_grad()
    def evaluate(params, xb, yb, mb):
        loss_sum = torch.zeros((), dtype=torch.float32, device=xb.device)
        correct_sum = torch.zeros_like(loss_sum)
        count = torch.zeros_like(loss_sum)
        for x, y, m in zip(xb, yb, mb):
            if preprocess is not None:
                x = preprocess(x)
            logits = apply_fn(params, x).float()
            nll = F.cross_entropy(logits, y, reduction="none")
            correct = (logits.argmax(dim=1) == y).float()
            loss_sum = loss_sum + (nll * m).sum()
            correct_sum = correct_sum + (correct * m).sum()
            count = count + m.sum()
        count = torch.clamp(count, min=1.0)
        return {"loss": loss_sum / count, "accuracy": correct_sum / count}

    return evaluate
