"""Per-round client failure model (robustness/faults.py of the JAX
package).

A :class:`FailureModel` built from the config draws each round's failure
mask from the round's fault key, as the JAX round program does, with the
port's replay of ``jax.random`` (ops/prng.py): the masks are bitwise the
JAX package's, the round-correlated draws included. The draws are a few
words per client and run on the host; the corruption and the state freeze
are tensor ops on the cohort's ``[M, P]`` stacks.

Failure modes (``config.failure_mode``):

  * ``dropout``: the client never trains this round. Its upload is
    excluded (weight 0, the survivors renormalized) and its persistent
    per-client state is frozen.
  * ``straggler``: the client trains, but its upload arrives after the
    round closed and is excluded like a dropout; its local state advances.
  * ``corrupt_nan``: the client's upload is all NaN, at full weight.
  * ``corrupt_scale``: the client's upload is its params scaled by
    :data:`CORRUPT_SCALE` (finite Byzantine garbage), at full weight.

``failure_correlation`` replaces each client's uniform draw, with that
probability, by one draw shared across the round's cohort: the marginal
failure rate stays ``failure_prob`` while failures cluster into bad rounds.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from distributed_learning_simulator_tpu_torch.ops import prng
from distributed_learning_simulator_tpu_torch.ops.cohort import to_device, tree_map

#: Multiplier a ``corrupt_scale`` client applies to its upload.
CORRUPT_SCALE = 100.0

MODES = ("none", "dropout", "straggler", "corrupt_nan", "corrupt_scale")


def all_finite(x: torch.Tensor) -> bool:
    """Whether every element of ``x`` is finite, as a host bool."""
    return bool(finite_flag(x))


def finite_flag(x: torch.Tensor) -> torch.Tensor:
    """Whether every element of ``x`` is finite, as a 0-dim bool tensor on
    ``x``'s device: the round's selects use it without waiting for the
    card."""
    return torch.isfinite(x).all()


def _rows(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-model ``[M]`` mask shaped to broadcast over ``x [M, ...]``."""
    return to_device(mask, x.device).reshape((-1,) + (1,) * (x.dim() - 1))


@dataclass(frozen=True)
class FailureModel:
    """The failure configuration; each round's draws are a function of its
    fault key alone."""

    mode: str
    prob: float
    correlation: float = 0.0
    seed: int = 0

    @classmethod
    def from_config(cls, config) -> "FailureModel | None":
        """None when no failure model is active (``mode='none'`` or
        ``prob <= 0``): such a run keeps the exact failure-free key chain."""
        mode = config.failure_mode or "none"
        prob = float(config.failure_prob)
        if mode == "none" or prob <= 0.0:
            return None
        if mode not in MODES:
            raise ValueError(
                f"unknown failure_mode {mode!r}; known: {', '.join(MODES)}"
            )
        return cls(mode=mode, prob=prob,
                   correlation=float(config.failure_correlation),
                   seed=int(config.failure_seed))

    @property
    def excludes_update(self) -> bool:
        """A failed client contributes nothing to aggregation."""
        return self.mode in ("dropout", "straggler")

    @property
    def corrupts_upload(self) -> bool:
        """A failed client uploads garbage with its full weight."""
        return self.mode in ("corrupt_nan", "corrupt_scale")

    @property
    def routes_to_buffer(self) -> bool:
        """Under async federation (robustness/arrivals.py) a failed client
        arrives late into the staleness buffer instead of being excluded:
        only a straggler (its upload exists and arrives; a dropout never
        trained, the corrupt modes damage the payload)."""
        return self.mode == "straggler"

    @property
    def freezes_client_state(self) -> bool:
        """A dropout never ran, so its persistent state must not advance;
        a straggler trained and keeps its new state."""
        return self.mode == "dropout"

    def draw_failed(self, key, n: int) -> np.ndarray:
        """Bool ``[n]`` failure mask of one round's cohort (positions in
        draw order). ``fold_in(key, seed)`` keeps the failure stream apart
        from every other draw of the round."""
        k = prng.fold_in(key, self.seed)
        k_common, k_ind, k_mix = prng.split(k, 3)
        u = prng.uniform(k_ind, (n,))
        if self.correlation > 0.0:
            use_common = (prng.uniform(k_mix, (n,))
                          < np.float32(self.correlation))
            u = np.where(use_common, prng.uniform(k_common, ()), u)
        return u < np.float32(self.prob)

    def corrupt_stack(self, stack: torch.Tensor, failed) -> torch.Tensor:
        """The corrupt modes' damage to the failed rows of an upload stack
        ``[M, P]`` (the raw uploads, before any payload transform)."""
        f = _rows(torch.as_tensor(failed), stack)
        if self.mode == "corrupt_nan":
            bad = torch.full_like(stack, float("nan"))
        else:
            bad = stack * CORRUPT_SCALE
        return torch.where(f, bad, stack)

    def freeze_failed_state(self, failed, old_state, new_state):
        """The failed rows of the per-client state (a tensor or a dict of
        ``[M, ...]`` tensors) revert to their round-start values; None
        passes through."""
        if old_state is None or new_state is None:
            return new_state
        f = torch.as_tensor(failed)
        return tree_map(lambda old, new: torch.where(_rows(f, new), old, new),
                        old_state, new_state)
