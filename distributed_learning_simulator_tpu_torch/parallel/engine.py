"""Local training over a chunk of clients, and server evaluation
(parallel/engine.py of the JAX package).

Each model is one flat tensor (models/registry.py ``ParamLayout``): the f32
global model, a client's local copy, its gradient and its momentum trace.
So the optimizer step, the bf16 stochastic rounding and the aggregation are
a handful of flat tensor ops, whatever the number of parameter leaves.

The JAX package vmaps ``local_train`` over a chunk of clients. So does the
port: :func:`make_chunk_train_fn` trains M clients at once, their params an
``[M, P]`` stack, with one ``torch.func.vmap`` of ``grad_and_value`` per
optimizer step (one forward and one backward for the whole chunk; the
models' hand-written kernels fold the client axis into their leading axis,
models/resnet.py). The optimizer step (SGD with momentum, or Adam / AdamW
with a step count per client), the lr scale and the bf16 stochastic
rounding are elementwise ops on the stack, so each row is the one-client
computation bit for bit. Each client's randomness — each epoch's
batch order, the bf16 rounding salt and the augmentation key — comes from
its key of the JAX package's key chain (:func:`client_draws`, ops/prng.py),
so it is the reference's bit for bit, or is handed in by the caller.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from distributed_learning_simulator_tpu_torch.ops import prng
from distributed_learning_simulator_tpu_torch.ops.cohort import (
    batched_take,
    to_device,
    tree_map,
)
from distributed_learning_simulator_tpu_torch.ops.quantize import (
    MASK32,
    Segments,
    hash_mix,
)
from distributed_learning_simulator_tpu_torch.telemetry.recompile import (
    tracked,
)
from distributed_learning_simulator_tpu_torch.utils.tracing import (
    profile_step,
)

#: Salt advance per rounded leaf (the JAX package's ``0x9E3779B9``).
SALT_STEP = 0x9E3779B9


@contextlib.contextmanager
def no_vmap_fallback():
    """Inside, an op with no batching rule under ``torch.func.vmap`` raises
    instead of taking functorch's per-example loop, which it would do with
    no more than a performance warning: a batched path that silently ran
    client by client would still give the right numbers. The tests and
    chip_smoke.py run the batched paths under it."""
    was = torch._C._functorch._is_vmap_fallback_enabled()
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        yield
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(was)


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


def fma(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """f32 fused multiply-add ``a * b + c`` as XLA's fused programs compute
    it: the product of two f32 values is exact in f64, and the f64 sum
    rounded to f32 is the fused result (ops/sign.vote_apply_leaf)."""
    return (a.double() * float(np.float32(b)) + c.double()).float()


def _powf(base: float, exponent: np.ndarray) -> np.ndarray:
    """f32 ``base ** exponent`` for an integer exponent as XLA computes it
    on the CPU: the f64 power of the f32 base, rounded to f32 (torch's and
    libm's f32 powers differ in the last bit for some exponents)."""
    return (np.float64(np.float32(base)) ** exponent.astype(np.float64)
            ).astype(np.float32)


class Adam:
    """optax's ``adam`` (``adamw=False``) or ``adamw`` on flat tensors:
    ``scale_by_adam(b1=0.9, b2=0.999, eps=1e-8, eps_root=0)``, then for
    adamw ``add_decayed_weights(weight_decay)``, then ``scale(-lr)``.

    The state is ``{"count", "mu", "nu"}``: the moments in the params'
    dtype (optax's ``mu_dtype=None``, so bf16 under bf16 local state) and
    an int32 step count per model, which lives on the host: the bias
    corrections ``1 - b**count`` are computed there exactly as XLA computes
    them. Params ``[P]`` take a scalar count,
    a chunk's ``[M, P]`` stack an ``[M]`` one, so clients whose state was
    frozen (a dropout) keep their own count.

    In bf16 every operation rounds to bf16 as JAX's does, the Python
    constants included (a weak-typed scalar takes the array's dtype before
    the operation). In f32 the arithmetic is that of XLA's fused program:
    ``mu = fma(g, 1 - b1, b1 * mu)``, ``nu = fma(g * g, 1 - b2, b2 * nu)``,
    the two bias-correction divisions merged into one, ``mu / (bc1 *
    (sqrt(nu / bc2) + eps))``, and adamw's ``fma(p, wd, update)``, each
    fused multiply-add computed in f64 and rounded once (:func:`fma`).
    ``server=True`` is the JAX server update's fusion, which contracts the
    other product of nu's sum: ``nu = fma(nu, b2, g * g * (1 - b2))``."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, learning_rate: float, weight_decay: float = 0.0,
                 adamw: bool = False, server: bool = False):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.adamw = adamw
        self.server = server

    def init(self, params: torch.Tensor):
        return {
            "count": torch.zeros(params.shape[:-1], dtype=torch.int32),
            "mu": torch.zeros_like(params),
            "nu": torch.zeros_like(params),
        }

    def update(self, grads, state, params):
        direction, state = self.direction(grads, state, params)
        lr = torch.full((), -self.learning_rate, dtype=direction.dtype,
                        device=direction.device)
        return lr * direction, state

    def direction(self, grads, state, params):
        """The update before its ``scale(-lr)``, and the new state."""
        dtype = grads.dtype
        count = np.asarray(np.minimum(
            state["count"].numpy().astype(np.int64) + 1,
            np.iinfo(np.int32).max), dtype=np.int32)

        def const(v):
            return torch.full((), v, dtype=dtype, device=grads.device)

        def correction(decay):
            """``1 - decay**count`` in f32, cast to the moments' dtype, as
            a column over the models."""
            bc = (np.float32(1) - _powf(decay, count)).astype(np.float32)
            return to_device(bc, grads.device).to(dtype)[
                ..., None]

        def sqrt(x):
            # The f32 square root correctly rounded (torch's vectorized CPU
            # sqrt is not), then cast to the moments' dtype.
            return torch.sqrt(x.double()).float().to(dtype)

        if dtype == torch.float32:
            mu = fma(grads, 1 - self.B1, const(self.B1) * state["mu"])
            if self.server:
                nu = fma(state["nu"], self.B2,
                         grads * grads * const(1 - self.B2))
            else:
                nu = fma(grads * grads, 1 - self.B2,
                         const(self.B2) * state["nu"])
            updates = mu / (correction(self.B1) * (
                sqrt(nu / correction(self.B2)) + const(self.EPS)))
            if self.adamw:
                updates = fma(params, self.weight_decay, updates)
        else:
            mu = const(1 - self.B1) * grads + const(self.B1) * state["mu"]
            nu = (const(1 - self.B2) * (grads * grads)
                  + const(self.B2) * state["nu"])
            updates = (mu / correction(self.B1)) / (
                sqrt(nu / correction(self.B2)) + const(self.EPS))
            if self.adamw:
                updates = updates + const(self.weight_decay) * params
        return updates, {"count": torch.from_numpy(count), "mu": mu,
                         "nu": nu}


def make_optimizer(name: str, learning_rate: float, momentum: float = 0.0,
                   weight_decay: float = 0.0):
    """Optimizer registry, the JAX package's ``make_optimizer``: ``sgd``
    (weight decay chained before it), ``adam`` (which, as there, takes no
    weight decay) and ``adamw``."""
    key = name.lower()
    if key == "sgd":
        return SGD(learning_rate, momentum, weight_decay)
    if key in ("adam", "adamw"):
        return Adam(learning_rate, weight_decay, adamw=key == "adamw")
    raise ValueError(f"unknown optimizer {name!r}")


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


#: Elements of a stack rounded at once (int64 temporaries of 512 MB each).
ROUND_ELEMENTS = 1 << 26


def row_slices(stack: torch.Tensor) -> list[slice]:
    """Slices of whole rows of an ``[M, P]`` stack, each at most
    ``ROUND_ELEMENTS`` elements (one row at least): how a per-element hash
    over the stack is cut so that its int64 temporaries stay bounded. The
    hash is per element, so each row's result is that of a call on the row
    alone."""
    rows = max(1, ROUND_ELEMENTS // max(1, stack.shape[1]))
    return [slice(r, r + rows) for r in range(0, stack.shape[0], rows)]


class FlatRounder:
    """``_sr_tree_to_bf16`` over a flat parameter vector in one pass: the
    per-element salt is ``salt + leaf_index * 0x9E3779B9`` (leaves in the
    layout's order, the JAX tree's leaf order), and the salt advances by one
    step per leaf, exactly as the leaf-by-leaf loop would.

    An ``[M, P]`` stack takes one salt per row (each client's own), and is
    rounded a :func:`row_slices` slice at a time."""

    def __init__(self, layout, device):
        self.n_leaves = len(layout.names)
        steps = torch.arange(self.n_leaves, device=device) * SALT_STEP
        self.offsets = Segments(layout.numels, device).spread(steps & MASK32)

    def __call__(self, flat32: torch.Tensor, salt):
        """``flat32 [P]`` with an int salt, or ``[M, P]`` with M salts;
        returns ``(bf16 of the same shape, advanced salt(s))``."""
        if flat32.dim() == 1:
            rounded, salts = self(flat32[None], [salt])
            return rounded[0], salts[0]
        step = self.n_leaves * SALT_STEP
        salts = to_device([int(v) for v in salt], flat32.device,
                          torch.int64)
        out = torch.empty(flat32.shape, dtype=torch.bfloat16,
                          device=flat32.device)
        for rows in row_slices(flat32):
            salt_rows = (self.offsets + salts[rows, None]) & MASK32
            out[rows], _ = _sr_to_bf16(flat32[rows], salt_rows)
        return out, [(int(v) + step) & MASK32 for v in salt]


def client_draws(client_key, n_slots: int, epochs: int,
                 augment: bool = False):
    """One client's randomness for one round, from its training key as the
    JAX package's ``local_train`` derives it: the bf16 rounding salt is the
    first word of ``fold_in(key, 7)``, and epoch e's batch order is
    ``permutation(split(key, epochs)[e], n_slots)``. Returns ``(epoch_perms,
    sr_salt)``. With ``augment`` the key is first split into ``(key,
    aug_key)`` (so the batch orders change only when augmenting) and the
    result is ``(epoch_perms, sr_salt, aug_key)``."""
    salt = int(prng.fold_in(client_key, 7)[0])
    aug_key = None
    if augment:
        client_key, aug_key = prng.split(client_key, 2)
    perms = [torch.from_numpy(prng.permutation(k, n_slots).astype(np.int64))
             for k in prng.split(client_key, epochs)]
    if augment:
        return perms, salt, aug_key
    return perms, salt


def stack_draws(draws):
    """Per-member :func:`client_draws` results -> ``(epoch_perms [M, E,
    n_slots] int64, sr_salts [M], aug_keys [M] or None)``, the chunk form
    :func:`make_chunk_train_fn` takes."""
    perms = torch.stack([torch.stack([torch.as_tensor(p, dtype=torch.int64)
                                      for p in d[0]]) for d in draws])
    salts = [int(d[1]) for d in draws]
    aug_keys = [d[2] for d in draws] if len(draws[0]) > 2 else None
    return perms, salts, aug_keys


def chunk_decoder(preprocess):
    """``preprocess`` over a chunk's ``[M, B, ...]`` batch (it takes one
    ``[B, ...]`` batch): fold the client axis into the batch and back."""

    def decode(bx):
        m, b = bx.shape[:2]
        out = preprocess(bx.reshape((m * b,) + tuple(bx.shape[2:])))
        return out.reshape((m, b) + tuple(out.shape[1:]))

    return decode


def make_chunk_train_fn(
    apply_fn: Callable,
    optimizer: SGD | Adam,
    layout,
    local_epochs: int,
    batch_size: int,
    preprocess: Callable | None = None,
    compute_dtype: torch.dtype | None = None,
    device=None,
    param_transform: Callable | None = None,
    reset_optimizer: bool = True,
    augment: Callable | None = None,
    collect_stats: bool = False,
):
    """Build ``train_chunk(global_flat, xs, ys, mask, epoch_perms, sr_salts,
    aug_keys=None, lr_scale=1.0, opt_state=None) -> (params [M, P],
    opt_state, metrics)``: M clients' local runs as one program, the JAX
    package's ``vmap(local_train)`` over a chunk.

    ``global_flat`` is the one ``[P]`` model every member starts from, or
    an ``[M, P]`` stack of per-member starting models (a sweep fleet's
    chunk: experiment e's rows start from e's global model). ``lr_scale``
    is a float for every member or an f32 ``[M]`` tensor of per-member
    factors on the params' device.

    ``xs, ys, mask`` are the members' ``[M, n_slots, ...]`` shards,
    ``epoch_perms`` ``[M, E, n_slots]`` their batch orders (a permutation
    of the slots per epoch), ``sr_salts`` their M bf16 rounding salts,
    ``aug_keys`` their M augmentation keys. Each step gathers every
    member's own batch of ``batch_size`` (``[M, B, ...]``), and one
    ``torch.func.vmap(torch.func.grad_and_value(loss))`` computes the M
    losses and gradients. A fully masked batch is still an optimizer step,
    as in the JAX scan. ``metrics`` holds each member's last-epoch mean
    batch loss and accuracy, ``[M]`` device tensors.

    ``compute_dtype=torch.bfloat16``: the clients' params, grads and
    momenta live in bf16 for the local run. The f32 global model is cast
    with stochastic rounding salted by each member's salt, and every step
    adds the update to the params in f32 and rounds stochastically into
    bf16 storage.

    With ``reset_optimizer`` (``reset_client_optimizer``, the default) the
    optimizer starts fresh every round, the ``opt_state`` argument is
    ignored and None is returned in its place; otherwise the run starts
    from the members' persistent ``opt_state`` (SGD's momentum traces
    ``[M, P]``, or Adam's ``{"count" [M], "mu", "nu" [M, P]}``; f32, as the
    JAX package initializes them from the f32 global model; None for SGD
    without momentum) and returns their final state.

    ``augment(batch, keys)`` (ops/augment.py) transforms each decoded
    ``[M, B, ...]`` batch, member m with the key ``fold_in(fold_in(
    aug_keys[m], epoch), step)``, as the JAX scan does, in one pass.

    ``param_transform`` (flat -> flat, e.g. fed_quant's fake-quant) is
    applied to the params inside the loss, per member.

    ``collect_stats`` (telemetry/client_stats.py): ``metrics`` also holds
    each member's ``loss_first`` (the first step's batch loss: the loss of
    the incoming global model on its first batch) and ``grad_sq_mean`` (the
    mean over epochs of the mean over steps of the squared gradient L2
    norm, in f32). Chosen when the function is built; either way the run
    draws nothing more and computes the same params.

    The returned function counts its first-seen call signatures for the
    recompile counter (telemetry/recompile.py, ``train_chunk``).
    """
    loss_fn = make_loss_fn(
        lambda flat, x: apply_fn(layout.unflatten(flat), x), param_transform
    )
    grad_fn = torch.func.vmap(
        torch.func.grad_and_value(loss_fn, has_aux=True))
    sr_enabled = compute_dtype == torch.bfloat16
    rounder = FlatRounder(layout, device) if sr_enabled else None
    decode = chunk_decoder(preprocess) if preprocess is not None else None

    def train_chunk(global_flat, xs, ys, mask, epoch_perms, sr_salts,
                    aug_keys=None, lr_scale=1.0, opt_state=None):
        m = xs.shape[0]
        salts = list(sr_salts)
        with torch.no_grad():
            # Never written in place: every step makes a new stack.
            start = (global_flat.expand(m, *global_flat.shape)
                     if global_flat.dim() == 1 else global_flat)
            if sr_enabled:
                params, salts = rounder(start, salts)
            else:
                params = start
            if reset_optimizer:
                opt_state = optimizer.init(params)
        steps = xs.shape[1] // batch_size
        epoch_perms = to_device(epoch_perms, xs.device)
        epoch_loss = epoch_acc = None
        loss_first = None
        epoch_grad_sq = []
        for epoch in range(epoch_perms.shape[1]):
            losses, accs, grad_sqs = [], [], []
            for step in range(steps):
                idx = epoch_perms[:, epoch,
                                  step * batch_size:(step + 1) * batch_size]
                bx = batched_take(xs, idx)
                by = batched_take(ys, idx)
                bm = batched_take(mask, idx)
                if decode is not None:
                    bx = decode(bx)
                if augment is not None:
                    bx = augment(bx, [
                        prng.fold_in(prng.fold_in(k, epoch), step)
                        for k in aug_keys
                    ])
                grads, (loss, acc) = grad_fn(params, bx, by, bm)
                if collect_stats:
                    grad_sqs.append(squared_norms(grads))
                with torch.no_grad():
                    updates, opt_state = optimizer.update(
                        grads, opt_state, params
                    )
                    if isinstance(lr_scale, torch.Tensor):
                        # One factor per row (a sweep fleet's experiments):
                        # the scalar's f32 product row by row, and a row's
                        # factor 1.0 leaves its update as it was.
                        updates = (updates.float() * lr_scale[:, None]).to(
                            updates.dtype
                        )
                    elif lr_scale != 1.0:
                        # f32 math, original dtype kept (JAX: the round
                        # schedule factor multiplies the final update).
                        updates = (updates.float() * lr_scale).to(
                            updates.dtype
                        )
                    if sr_enabled:
                        params, salts = rounder(
                            params.float() + updates.float(), salts
                        )
                    else:
                        params = params + updates
                losses.append(loss.detach())
                accs.append(acc.detach())
                profile_step()
            epoch_loss = torch.stack(losses).mean(dim=0)
            epoch_acc = torch.stack(accs).mean(dim=0)
            if collect_stats:
                if loss_first is None:
                    loss_first = losses[0]
                epoch_grad_sq.append(torch.stack(grad_sqs).mean(dim=0))
        if not params.is_contiguous():  # no step ran: the broadcast view
            params = params.contiguous()
        metrics = {"loss": epoch_loss, "accuracy": epoch_acc}
        if collect_stats:
            metrics["loss_first"] = loss_first
            metrics["grad_sq_mean"] = torch.stack(epoch_grad_sq).mean(dim=0)
        return params, None if reset_optimizer else opt_state, metrics

    return tracked("train_chunk", train_chunk)


def squared_norms(stack: torch.Tensor) -> torch.Tensor:
    """Each row's squared L2 norm of an ``[M, P]`` stack, in f32, a
    :func:`row_slices` slice at a time (the f32 temporaries stay
    bounded)."""
    with torch.no_grad():
        return torch.cat([(stack[r].float() ** 2).sum(dim=1)
                          for r in row_slices(stack)])


def make_local_train_fn(apply_fn: Callable, optimizer: SGD | Adam, layout,
                        local_epochs: int, batch_size: int, **kwargs):
    """One client's run: ``local_train(global_flat, xs, ys, mask,
    epoch_perms, sr_salt, aug_key=None, lr_scale=1.0, opt_state=None) ->
    (params_flat, opt_state, metrics)``, :func:`make_chunk_train_fn` on a
    chunk of one (the JAX package's ``client_chunk_size=1``). Keyword
    arguments are :func:`make_chunk_train_fn`'s."""
    train_chunk = make_chunk_train_fn(apply_fn, optimizer, layout,
                                      local_epochs, batch_size, **kwargs)

    def local_train(global_flat, xs, ys, mask, epoch_perms, sr_salt,
                    aug_key=None, lr_scale=1.0, opt_state=None):
        perms = torch.stack([torch.as_tensor(p, dtype=torch.int64)
                             for p in epoch_perms])[None]
        params, state, metrics = train_chunk(
            global_flat, xs[None], ys[None], mask[None], perms, [sr_salt],
            aug_keys=None if aug_key is None else [aug_key],
            lr_scale=lr_scale,
            opt_state=tree_map(lambda t: t[None], opt_state),
        )
        return (params[0], tree_map(lambda t: t[0], state),
                {k: v[0] for k, v in metrics.items()})

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
    device scalars, fetched by the caller once.

    ``evaluate`` is plain tensor code over the model, so it vmaps over
    stacked models with the batches shared (:func:`make_models_eval_fn`):
    the JAX package's ``vmap(eval_one)`` of client eval and of the Shapley
    subset models."""

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


def make_models_eval_fn(eval_fn: Callable, layout,
                        transform: Callable | None = None):
    """``evaluate_models(models [K, P], xb, yb, mb) -> {"loss": [K],
    "accuracy": [K]}``: ``eval_fn`` (:func:`make_eval_fn`) over K flat
    models in one vmapped forward per eval batch, each model through
    ``transform`` first (fed_quant's fake-quant) when given. It counts its
    first-seen call signatures for the recompile counter
    (telemetry/recompile.py, ``evaluate_models``)."""

    def one(flat, xb, yb, mb):
        if transform is not None:
            flat = transform(flat)
        return eval_fn(layout.unflatten(flat), xb, yb, mb)

    batched = torch.func.vmap(one, in_dims=(0, None, None, None))

    @torch.no_grad()
    def evaluate_models(models, xb, yb, mb):
        return batched(models, xb, yb, mb)

    return tracked("evaluate_models", evaluate_models)


def make_experiment_round_fn(fleet_round_fn, lr_schedule: bool):
    """The sweep fleet's round over a leading experiment axis (sweep/
    engine.py; the JAX package's ``make_experiment_round_fn``, a
    ``jax.vmap`` of the whole round).

    The port's round plans on the host (the key chain, the cohort, the
    draws), so it is not vmapped: the experiment axis is folded into the
    chunk's model axis instead. ``fleet_round_fn`` is the algorithm's
    fleet form of its round body (``FedAvg.make_fleet_round_fn``): every
    experiment's chunk j trains as one program of E x M rows. Each
    experiment carries its own global model and key chain and replays the
    solo loop's ``key, round_key = split(key)`` before its round; the
    client data, masks and sizes are shared (the sweep's data contract).

    ``lr_schedule`` (the JAX operand rule): when True the returned function
    takes an f32 ``[E]`` vector, per experiment its lr factor times the
    round's schedule factor; when False the round runs at the scalar 1.0,
    as a solo round without a schedule.

    Returns ``fleet(params_e [E, P], keys_e, cx, cy, cmask, sizes[,
    lr_vec]) -> (new_params_e, new_keys_e, auxes)``, ``keys_e`` a list of E
    keys and ``auxes`` the E solo aux dicts. Per-client state is not
    carried (the sweep spec refuses it for fleets)."""

    def fleet(params_e, keys_e, cx, cy, cmask, sizes, lr_vec=None):
        keys_next, round_keys = [], []
        for key in keys_e:
            key, round_key = prng.split(key)
            keys_next.append(key)
            round_keys.append(round_key)
        lr_scale = 1.0
        if lr_schedule:
            lr_scale = to_device(np.asarray(lr_vec, dtype=np.float32),
                                 params_e.device)
        new_params, auxes = fleet_round_fn(params_e, cx, cy, cmask, sizes,
                                           round_keys, lr_scale=lr_scale)
        return new_params, keys_next, auxes

    return fleet


def make_experiment_eval_fn(eval_fn: Callable, layout):
    """The fleet's server eval of its E global models (the JAX package's
    ``make_experiment_eval_fn``): ``evaluate(params_e [E, P], xb, yb, mb)
    -> {"loss": [E], "accuracy": [E]}``, each experiment's model through
    ``eval_fn`` (:func:`make_eval_fn`) as a solo run evaluates its one,
    from a copy of its own (a solo run's global model is a tensor of its
    own, so its leaves' addresses are aligned alike), so that every
    round's test loss and accuracy are the solo run's bits. The
    JAX package vmaps the eval over the experiments; here one vmapped
    forward of E models (:func:`make_models_eval_fn`) takes other kernels
    than one model's: cuDNN's bf16 grouped convolutions at 4 groups
    against 1, cuBLAS's batched classifier head, and ``sum`` over ``[E,
    n]`` against ``[n]`` (tests/test_torch_fleet_replay_cuda.py)."""

    def evaluate(params_e, xb, yb, mb):
        outs = [eval_fn(layout.unflatten(row.clone()), xb, yb, mb)
                for row in params_e]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    return tracked("evaluate_models", evaluate)


def stack_rounds(values: list):
    """Per-round values -> one stacked value: tensors ``torch.stack``ed on
    their device (no host transfer), host numbers and arrays into one numpy
    array, dicts key by key."""
    first = values[0]
    if isinstance(first, dict):
        return {k: stack_rounds([v[k] for v in values]) for k in first}
    if isinstance(first, torch.Tensor):
        return torch.stack(values)
    return np.stack([np.asarray(v) for v in values])


def make_batched_round_fn(round_fn, server_update_fn, eval_fn, length: int,
                          async_mode: bool = False, streamed: bool = False):
    """``length`` federated rounds back to back on the host, with no wait
    on the card between them (config.rounds_per_dispatch; the JAX
    package's ``make_batched_round_fn``, whose ``lax.scan`` this loop
    replays).

    Each round is the K=1 loop's sequence exactly: ``key, round_key =
    split(key)``, the round function, the server optimizer's step fed the
    round's quorum verdict, the server eval. So a dispatch of K rounds
    computes the same values as K single rounds, bitwise; only the metric
    fetch moves to the end of the dispatch. Nothing inside synchronizes
    with the card: the round functions decide on the device
    (algorithms/fedavg.py, sign_sgd.py) and send host vectors through
    pinned memory.

    ``async_mode``: the staleness buffer rides the loop, each round's
    ``aux["async_state"]`` popped and fed to the next round, the last one
    returned (never stacked).

    ``streamed``: the streamed calling convention with a sampled cohort
    (client_residency='streamed'; parallel/streaming.py). ``cx``, ``cy``,
    ``cmask`` and ``sizes`` are the dispatch's stacked ``[length, cohort,
    ...]`` upload and ``idx_k`` its per-round cohort ids (the host drew
    them from this key chain beforehand); round i gets slice ``[i]`` of
    each. ``client_state`` is None: the simulator refuses streamed
    batching with persistent per-client state, since cohorts within a
    dispatch may overlap.

    Returns ``batched(global_flat, client_state, server_state, key, cx, cy,
    cmask, sizes, eval_batches, lr_vec, async_state=None, round_kwargs=None,
    idx_k=None) -> (global_flat, client_state, server_state, key, metrics_k, aux_k[,
    async_state])``. ``lr_vec`` is the ``[length]`` f32 schedule factors
    (simulator ``lr_factors``); ``round_kwargs[i]`` optional extra
    arguments of round i (tests' draw overrides). ``metrics_k`` and
    ``aux_k`` are stacked ``[length, ...]`` (:func:`stack_rounds`): device
    values stay on the device for the dispatch's one fetch."""

    def batched(global_flat, client_state, server_state, key, cx, cy,
                cmask, sizes, eval_batches, lr_vec, async_state=None,
                round_kwargs=None, idx_k=None):
        metrics_list, aux_list = [], []
        for i in range(length):
            key, round_key = prng.split(key)
            kw = dict(round_kwargs[i]) if round_kwargs else {}
            if async_mode:
                kw["async_state"] = async_state
            operands = ((cx[i], cy[i], cmask[i], sizes[i], idx_k[i])
                        if streamed else (cx, cy, cmask, sizes))
            new_global, client_state, aux = round_fn(
                global_flat, client_state, *operands, round_key,
                lr_scale=float(lr_vec[i]), **kw)
            if async_mode:
                aux = dict(aux)
                async_state = aux.pop("async_state")
            if server_update_fn is not None:
                new_global, server_state = server_update_fn(
                    global_flat, new_global, server_state,
                    aux.get("round_rejected"))
            metrics_list.append(eval_fn(new_global, *eval_batches))
            aux_list.append(aux)
            global_flat = new_global
        out = (global_flat, client_state, server_state, key,
               stack_rounds(metrics_list), stack_rounds(aux_list))
        if async_mode:
            out = out + (async_state,)
        return out

    return batched
