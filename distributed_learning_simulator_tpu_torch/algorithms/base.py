"""Algorithm strategy interface (algorithms/base.py of the JAX package):
the part of it that the ported algorithms use.

An algorithm builds a **round function** — local training on every client,
then aggregation — keeps optional per-client state across rounds
(``init_client_state``), and may run a host-side ``post_round`` hook.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from distributed_learning_simulator_tpu_torch.ops.cohort import tree_map


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
    #: The round function runs inside a ``rounds_per_dispatch > 1``
    #: dispatch: its aux holds no per-round parameter stack and post_round
    #: needs only the dispatch's last model.
    supports_round_batching: bool = False
    #: The round loop may defer this algorithm's metric fetch, record and
    #: post_round until the next round is dispatched (``pipeline_rounds``):
    #: post_round only reads or logs. The Shapley algorithms' post_round
    #: evaluates subsets on the round's metrics, in the round.
    supports_round_pipelining: bool = True
    #: The round function takes the staleness buffer (async_mode='on').
    supports_async: bool = False
    #: The algorithm runs under ``client_residency='streamed'``. A sampled
    #: cohort's round takes the streamed calling convention:
    #: ``round_fn(global_flat, state_k, x_k, y_k, m_k, part_sizes, idx,
    #: key, lr_scale=1.0, ...)``, the cohort's slices gathered beforehand
    #: from the host shard store and ``idx`` its true client ids; the
    #: cohort's new state is returned, not scattered. FedAvg builds it. A
    #: full cohort (sign_SGD's vote over everyone, or participation 1)
    #: keeps the resident round, run on the population's arrays uploaded
    #: once. The Shapley algorithms refuse.
    supports_streamed_residency: bool = False

    def __init__(self, config):
        self.config = config

    def check_cohort(self, n_clients: int) -> None:
        """Validate the actual client count before any training runs."""

    @property
    def materializes_client_stack(self) -> bool:
        """Whether the round holds the cohort's ``[cohort, P]`` f32 stack
        (the simulator sizes it against the device budget first); FedAvg
        widens it with its materializing path."""
        return bool(self.keep_client_params)

    def make_round_fn(self, apply_fn: Callable, optimizer, layout,
                      n_clients: int, preprocess: Callable | None = None,
                      client_sizes=None, device=None,
                      mesh=None) -> Callable:
        """Return ``round_fn(global_flat, client_state, cx, cy, cmask,
        sizes, key, lr_scale=1.0, client_rng=None, payload_salts=None) ->
        (new_global_flat, new_client_state, aux)``.

        ``client_sizes`` (the host's per-client sample counts) enables the
        static size-aware regrouping of the chunks where the algorithm has
        one (FedAvg's ``bucket_client_work``); the simulator passes None
        under a mesh, whose blocks own the client axis's layout. With
        ``mesh`` (parallel/mesh.py) the client arrays and the state are
        ``Blocks`` over it.

        ``key`` is the round key of the JAX package's key chain
        (ops/prng.py); every draw of the round derives from it as in the
        JAX program. ``client_state`` is whatever per-client state
        persists across rounds (``init_client_state``; None when nothing
        does). ``client_rng(client, n_slots) -> (epoch_perms, sr_salt)``
        and ``payload_salts(client or None) -> per-leaf salts`` optionally
        replace the key chain's draws."""
        raise NotImplementedError

    def keeps_client_state(self) -> bool:
        """Whether clients carry state from round to round: the client
        optimizers are not reset. True also for an optimizer without state
        (SGD without momentum), whose per-client state is None here and an
        empty tree in the JAX package; the round loop's pipelining
        decision counts it as the JAX package does."""
        return not self.config.reset_client_optimizer

    def init_client_state(self, optimizer, global_flat, n_clients: int):
        """Initial per-client persistent state: None when client optimizers
        reset every round (the default), else each client's fresh optimizer
        state for the f32 global model, each leaf stacked ``[n_clients,
        ...]`` (None for an optimizer without state, SGD without
        momentum)."""
        if self.config.reset_client_optimizer:
            return None
        return tree_map(
            lambda t: t[None].expand((n_clients,) + t.shape).clone(),
            optimizer.init(global_flat))

    def make_server_update(self):
        """Optional server-side optimizer ``(init_fn, update_fn)``; None
        means the round aggregate becomes the next global model
        unchanged."""
        return None

    def cohort_indices(self, round_key, n_clients: int, alive=None,
                       n_participants=None):
        """The host's copy of the round's cohort draw from ``round_key``:
        the true client ids the round trains, or None when the cohort is
        the whole population. ``alive`` and ``n_participants`` are the
        dynamic population's draw over the registered index space with the
        departed masked, at the startup cohort size. The default is the
        whole population."""
        return None

    def gather_client_state(self, store, idx):
        """The cohort's rows of the host store's persistent per-client
        state (streamed residency's mirror of ops/cohort.cohort_take)."""
        return store.gather_state(idx)

    def scatter_client_state(self, store, idx, cohort_state) -> None:
        """Write a round's cohort state (host arrays) back into the host
        store (the mirror of ops/cohort.cohort_scatter)."""
        store.scatter_state(idx, cohort_state)

    def prepare(self, apply_fn, eval_fn, eval_batches=None) -> None:
        """One-time setup after the engine is built; ``eval_batches`` is
        the padded test set on the device."""

    def post_round(self, ctx: RoundContext) -> dict:
        """Host-side per-round hook; returns extra metrics to record/log."""
        return {}
