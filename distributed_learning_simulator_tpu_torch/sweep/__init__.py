"""Multi-experiment sweep engine (sweep/ of the JAX package).

``SweepSpec`` is the front door (validation, strategy resolution,
refusals); ``run_sweep`` executes a fleet — E experiments trained
together where the points allow, config-hash-scheduled through warm
programs where they don't. ``SweepScheduler`` and ``lean_supported`` are
the reusable warm-program pieces.
"""

from distributed_learning_simulator_tpu_torch.sweep.engine import (
    EXPERIMENT_AXIS,
    SweepScheduler,
    lean_supported,
    run_sweep,
)
from distributed_learning_simulator_tpu_torch.sweep.spec import (
    FLEET_AXES,
    SWEEP_STRATEGIES,
    SweepPoint,
    SweepSpec,
)

__all__ = [
    "EXPERIMENT_AXIS",
    "FLEET_AXES",
    "SWEEP_STRATEGIES",
    "SweepPoint",
    "SweepScheduler",
    "SweepSpec",
    "lean_supported",
    "run_sweep",
]
