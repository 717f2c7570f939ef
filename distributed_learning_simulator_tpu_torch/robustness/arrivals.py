"""Asynchronous federation: the arrival model, deadline rounds and the
staleness-weighted buffer (robustness/arrivals.py of the JAX package).

* :class:`AsyncFederation` comes from the config (``async_mode='off'``
  gives None, and every call site branches on that: a synchronous run is
  the pre-feature run).
* **Arrival model** (``arrival_model`` ``bimodal`` or ``lognormal``): each
  client has a persistent speed factor drawn from its true client index
  under ``arrival_seed`` (an ``arrival_slow_fraction`` share is
  ``arrival_slow_factor`` times slower), times a per-round jitter drawn
  from the round key through ``fold_in`` (uniform in [0.5, 1.5) for
  ``bimodal``, ``exp(sigma * N(0, 1))`` for ``lognormal``). The
  ``fold_in`` keeps the arrival stream apart from the round key's splits,
  so turning arrivals on re-rolls nothing else. The draws are the JAX
  package's, replayed on the host (ops/prng.py; ``exp`` as XLA's CPU
  ``exp`` computes it, :func:`xla_exp`).
* **Deadline rounds**: a client whose latency is at most
  ``round_deadline`` contributes fresh, as in synchronous FedAvg over the
  on-time sub-cohort. The round closes at ``min(deadline, max latency)``
  of simulated time; against the synchronous counterfactual (``max
  latency``) that gives the run's ``async_speedup_ratio``.
* **Staleness buffer**: a late upload's delta against the global model it
  trained from goes into one f32 parameter-sized accumulator on the
  device, weighted ``size * (1 + s)^(-staleness_alpha)`` with ``s`` the
  rounds late (``ceil(latency / deadline) - 1``; at least 1 for a
  straggler fault routed into the buffer). Once ``async_buffer_size``
  uploads have gathered, the buffered mean delta joins that round's fresh
  aggregate at its share of the combined weight, and the buffer resets. A
  non-finite late batch is dropped whole at insertion.

The arrival draws and the deadline split are host numpy (the cohort and
its latencies are known on the host); the buffer is tensors on the
device, updated with selects only, so a round never waits for the card
to decide (round batching, simulator.py). ``round_deadline=inf`` makes
the async round bitwise equal to the synchronous one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from distributed_learning_simulator_tpu_torch.ops import prng
from distributed_learning_simulator_tpu_torch.robustness.faults import (
    finite_flag,
)

ARRIVAL_MODES = ("none", "bimodal", "lognormal")
ASYNC_MODES = ("off", "on")

#: fold_in tag separating the arrival stream from every other use of the
#: round key.
_ARRIVAL_STREAM = 0x61727276  # "arrv"

_LOG2E = np.float32(1.44269504088896341)
_EXP_C1 = np.float32(0.693359375)
_EXP_C2 = np.float32(-2.12194440e-4)
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)
_EXP_HI = np.float32(88.7228391116729996)


def xla_exp(x) -> np.ndarray:
    """XLA's f32 ``exp`` on the CPU: Cephes' range reduction ``x - n ln2``
    (two fused multiply-adds) and degree-5 polynomial, scaled by ``2^n``
    (n = floor(x log2 e + 1/2)); bitwise equal to ``jnp.exp`` there."""
    f32 = np.float32
    fma = prng._fma
    x = np.clip(np.asarray(x, dtype=f32), -_EXP_HI, _EXP_HI)
    n = np.floor(fma(x, _LOG2E, f32(0.5)))
    r = fma(n, -_EXP_C1, x)
    r = fma(n, -_EXP_C2, r)
    r2 = r * r
    y = fma(r, f32(_EXP_P[0]), f32(_EXP_P[1]))
    for c in _EXP_P[2:]:
        y = fma(y, r, f32(c))
    y = f32(1) + fma(y, r2, r)
    scale = ((n.astype(np.int32) + 0x7F) << 23).view(f32)
    return np.maximum(y * scale, x).astype(f32)


def staleness_discount(staleness, alpha: float):
    """``(1 + s)^(-alpha)`` in f32: ``alpha=0`` keeps late updates at full
    weight, a larger ``alpha`` trusts them less."""
    s = np.asarray(staleness, dtype=np.float32)
    # XLA's f32 power: the f64 power of the f32 operands, rounded once.
    base = (np.float32(1) + s).astype(np.float64)
    return (base ** np.float64(np.float32(-alpha))).astype(np.float32)


@dataclass(frozen=True)
class AsyncFederation:
    """The async configuration; per-round draws and the buffer step are
    functions of the round key and the carried buffer state."""

    arrival_model: str
    slow_fraction: float
    slow_factor: float
    sigma: float
    seed: int
    deadline: float
    buffer_size: int
    alpha: float

    @classmethod
    def from_config(cls, config) -> "AsyncFederation | None":
        """None when ``async_mode='off'`` (the default)."""
        mode = (getattr(config, "async_mode", "off") or "off").lower()
        if mode == "off":
            return None
        if mode not in ASYNC_MODES:
            raise ValueError(
                f"unknown async_mode {mode!r}; known: "
                + ", ".join(ASYNC_MODES)
            )
        arrival = getattr(config, "arrival_model", "none") or "none"
        if arrival == "none":
            raise ValueError(
                "async_mode='on' needs an arrival model to order uploads "
                "against round_deadline; set arrival_model='bimodal' or "
                "'lognormal'"
            )
        if arrival not in ARRIVAL_MODES:
            raise ValueError(
                f"unknown arrival_model {arrival!r}; known: "
                + ", ".join(ARRIVAL_MODES)
            )
        return cls(
            arrival_model=arrival,
            slow_fraction=float(getattr(config, "arrival_slow_fraction", 0.2)),
            slow_factor=float(getattr(config, "arrival_slow_factor", 8.0)),
            sigma=float(getattr(config, "arrival_sigma", 0.5)),
            seed=int(getattr(config, "arrival_seed", 0)),
            deadline=float(getattr(config, "round_deadline", float("inf"))),
            buffer_size=int(getattr(config, "async_buffer_size", 8)),
            alpha=float(getattr(config, "staleness_alpha", 0.5)),
        )

    # ---- draws (host) ------------------------------------------------------
    def speed_factors(self, client_ids) -> np.ndarray:
        """Persistent per-client slowdown factors (1.0, or ``slow_factor``
        for the slow share), keyed by the true client index under
        ``arrival_seed`` only."""
        k = prng.fold_in(prng.key(self.seed), _ARRIVAL_STREAM)
        u = np.asarray([prng.uniform(prng.fold_in(k, int(i)), ())
                        for i in np.asarray(client_ids).reshape(-1)],
                       dtype=np.float32)
        return np.where(u < np.float32(self.slow_fraction),
                        np.float32(self.slow_factor),
                        np.float32(1.0)).astype(np.float32)

    def speed_table(self, n_clients: int) -> np.ndarray:
        """The whole population's :meth:`speed_factors`, built once."""
        return self.speed_factors(np.arange(n_clients))

    def draw_latency(self, key, client_ids, speeds=None) -> np.ndarray:
        """One round's ``[n]`` simulated upload latencies (speed factor
        times the round's jitter, in ``round_deadline`` units), from
        ``fold_in(fold_in(round_key, tag), arrival_seed)``."""
        k = prng.fold_in(prng.fold_in(key, _ARRIVAL_STREAM), self.seed)
        n = int(np.asarray(client_ids).shape[0])
        if self.arrival_model == "bimodal":
            jitter = prng.uniform(k, (n,), 0.5, 1.5)
        else:  # lognormal (from_config validated the name)
            jitter = xla_exp(prng.normal(k, (n,), scale=self.sigma))
        if speeds is None:
            speeds = self.speed_factors(client_ids)
        return (np.asarray(speeds, dtype=np.float32) * jitter).astype(
            np.float32)

    def classify(self, latency, forced_late=None):
        """Split a round's cohort against the deadline: ``(on_time,
        staleness, discount, eff_latency)``. A straggler fault routed into
        the buffer (``forced_late``) arrives one deadline after its drawn
        latency, at staleness at least 1; at ``deadline=inf`` every other
        client is on time at staleness 0."""
        f32 = np.float32
        latency = np.asarray(latency, dtype=f32)
        if forced_late is not None and math.isfinite(self.deadline):
            latency = np.where(forced_late, latency + f32(self.deadline),
                               latency).astype(f32)
        on_time = latency <= f32(self.deadline)
        s = np.maximum(np.ceil(latency / f32(self.deadline)) - f32(1),
                       f32(0)).astype(f32)
        if forced_late is not None:
            on_time = on_time & ~forced_late
            s = np.where(forced_late, np.maximum(s, f32(1)), s).astype(f32)
        return on_time, s, staleness_discount(s, self.alpha), latency

    def durations(self, latency):
        """Simulated round seconds ``(async, sync)``: the deadline server
        closes at ``min(deadline, max latency)``, the synchronous one waits
        for the slowest client."""
        slowest = np.float32(np.max(latency))
        return np.minimum(slowest, np.float32(self.deadline)), slowest

    # ---- the buffer (device) -----------------------------------------------
    def init_state(self, global_flat: torch.Tensor) -> dict:
        """The round-0 buffer: an f32 parameter-sized accumulator of
        discounted late deltas and three scalars, on the model's device;
        carried round to round, checkpointed and restored."""
        dev = global_flat.device
        return {
            "buf_sum": torch.zeros(global_flat.shape, dtype=torch.float32,
                                   device=dev),
            "buf_weight": torch.zeros((), dtype=torch.float32, device=dev),
            "buf_count": torch.zeros((), dtype=torch.int32, device=dev),
            "clock": torch.zeros((), dtype=torch.float32, device=dev),
        }

    def absorb_and_apply(self, state, global_flat, fresh_agg, a_tot,
                         late_sum, b_tot, n_late, sim_duration):
        """One round's buffer step: insert the late batch, fire the
        ``async_buffer_size`` trigger, make the round's aggregate.

        ``fresh_agg`` is the on-time cohort's aggregate over weights
        summing to ``a_tot``; ``late_sum`` the discounted weighted sum of
        the late clients' processed uploads (total weight ``b_tot``, host
        f32, over ``n_late`` uploads). Returns ``(new_global, applied,
        state_inserted, state_next)``: ``fresh_agg`` selected bitwise
        unless the trigger fired, else the buffered mean delta joined at
        its ``buf_weight / (a_tot + buf_weight)`` share; the state with
        the inserts but no reset (what a quorum-rejected round carries
        on) and the next state (reset when applied). ``applied`` is a
        device bool."""
        g32 = global_flat.float()
        b_tot = float(np.float32(b_tot))
        late_delta = late_sum - b_tot * g32
        ins_ok = finite_flag(late_delta) & bool(n_late > 0)
        zero = torch.zeros((), dtype=torch.float32, device=g32.device)
        buf_sum = state["buf_sum"] + torch.where(ins_ok, late_delta, zero)
        buf_weight = state["buf_weight"] + torch.where(
            ins_ok, torch.full_like(zero, b_tot), zero)
        buf_count = state["buf_count"] + torch.where(
            ins_ok, torch.full_like(state["buf_count"], int(n_late)),
            torch.zeros_like(state["buf_count"]))
        applied = buf_count >= self.buffer_size
        a_f = float(np.float32(a_tot))
        beta = torch.where(
            applied, buf_weight / torch.clamp(a_f + buf_weight, min=1e-12),
            zero)
        fresh32 = fresh_agg.float()
        fresh_delta = fresh32 - g32 if a_f > 0 else torch.zeros_like(g32)
        combined = (g32 + (1.0 - beta) * fresh_delta
                    + beta * (buf_sum / torch.clamp(buf_weight, min=1e-12)))
        new_global = torch.where(applied, combined.to(fresh_agg.dtype),
                                 fresh_agg)
        clock = state["clock"] + float(np.float32(sim_duration))
        state_inserted = {
            "buf_sum": buf_sum,
            "buf_weight": buf_weight,
            "buf_count": buf_count,
            "clock": clock,
        }
        state_next = {
            "buf_sum": torch.where(applied, zero, buf_sum),
            "buf_weight": torch.where(applied, zero, buf_weight),
            "buf_count": torch.where(applied,
                                     torch.zeros_like(buf_count), buf_count),
            "clock": clock,
        }
        return new_global, applied, state_inserted, state_next
