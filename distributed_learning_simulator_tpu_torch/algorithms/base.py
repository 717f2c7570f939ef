"""Algorithm strategy interface (algorithms/base.py of the JAX package):
the part of it that the ported algorithms use.

An algorithm builds a **round function** — local training on every client,
then aggregation — keeps optional per-client state across rounds
(``init_client_state``), and may run a host-side ``post_round`` hook.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable


@dataclass
class RoundContext:
    """Everything a host-side post_round hook may need for one round."""

    round_idx: int  # 0-based
    global_params: Any  # aggregated flat params after this round
    prev_global_params: Any  # flat params before this round
    sizes: Any  # [n_clients] aggregation weights
    aux: dict  # round_fn diagnostics
    metrics: dict  # server-side eval of global_params {'loss', 'accuracy'}
    prev_metrics: dict | None  # eval of prev_global_params
    eval_batches: tuple  # (xb, yb, mb) padded test set on the device
    log_dir: str | None
    layout: Any = None  # models/registry.ParamLayout of the flat params
    extra: dict = field(default_factory=dict)


class Algorithm:
    """Base strategy. Subclasses set ``name`` (registry key) and implement
    ``make_round_fn``."""

    name: str = ""
    #: Truthy: the round keeps every cohort client's payload-processed
    #: upload as an f32 ``[cohort, P]`` stack in ``aux["client_params"]``
    #: for post_round (the Shapley algorithms).
    keep_client_params: bool = False

    def __init__(self, config):
        self.config = config

    def check_cohort(self, n_clients: int) -> None:
        """Validate the actual client count before any training runs."""

    def make_round_fn(self, apply_fn: Callable, optimizer, layout,
                      n_clients: int, preprocess: Callable | None = None,
                      client_sizes=None, device=None) -> Callable:
        """Return ``round_fn(global_flat, client_state, cx, cy, cmask,
        sizes, key, lr_scale=1.0, client_rng=None, payload_salts=None) ->
        (new_global_flat, new_client_state, aux)``.

        ``key`` is the round key of the JAX package's key chain
        (ops/prng.py); every draw of the round derives from it as in the
        JAX program. ``client_state`` is whatever per-client state
        persists across rounds (``init_client_state``; None when nothing
        does). ``client_rng(client, n_slots) -> (epoch_perms, sr_salt)``
        and ``payload_salts(client or None) -> per-leaf salts`` optionally
        replace the key chain's draws."""
        raise NotImplementedError

    def init_client_state(self, optimizer, global_flat, n_clients: int):
        """Initial per-client persistent state; None when client optimizers
        reset every round (the only mode ported: config.py refuses
        ``reset_client_optimizer=False``)."""
        return None

    def make_server_update(self):
        """Optional server-side optimizer; None means the round aggregate
        becomes the next global model unchanged."""
        return None

    def prepare(self, apply_fn, eval_fn, eval_batches=None) -> None:
        """One-time setup after the engine is built; ``eval_batches`` is
        the padded test set on the device."""

    def post_round(self, ctx: RoundContext) -> dict:
        """Host-side per-round hook; returns extra metrics to record/log."""
        return {}
