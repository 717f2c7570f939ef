"""The hardware table of the predictive cost model (telemetry/topologies.py
of the JAX package, with the port's own rows).

Numbers are nominal datasheet peaks per chip: dense bf16 TFLOP/s, HBM GB/s
(SI), aggregate chip-to-chip GB/s, and a USD price per chip-hour. Real
programs reach a measured fraction of these peaks, the fitted
``costmodel.DEFAULT_EFFICIENCY``, so the table stays at datasheet values.

* ``h100-sxm-1``, ``-4``, ``-8``: NVIDIA H100 SXM5 80GB, from NVIDIA's H100
  Tensor Core GPU datasheet (SXM column): 989 TFLOP/s dense BF16 tensor
  core (1979 with sparsity, not used here), 3.35 TB/s HBM3, 900 GB/s
  NVLink. No public list price is cited, so the rows are priced 0.0:
  **unpriced**, and their ``usd_*`` fields read 0.
* ``cpu-host``: the CPU a test run uses, priced at zero (self-hosted), so
  a prediction degrades instead of failing where no card applies.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Topology:
    """One hardware configuration the cost model can price.
    ``peak_tflops``, ``hbm_gbps`` and ``ici_gbps`` are per-chip peaks;
    ``chips`` is the data-parallel width the client axis would shard over.
    ``ici_gbps=0`` means no interconnect: no collective volume is charged
    to it."""

    name: str
    chips: int
    peak_tflops: float      # dense bf16 peak, TFLOP/s per chip
    hbm_gbps: float         # memory bandwidth, GB/s (SI) per chip
    ici_gbps: float         # chip-to-chip bandwidth, GB/s per chip
    usd_per_chip_hour: float


#: NVIDIA H100 SXM5 datasheet: dense BF16 tensor-core TFLOP/s, HBM3 GB/s,
#: NVLink GB/s.
_H100_SXM = dict(peak_tflops=989.0, hbm_gbps=3350.0)
_NVLINK_GBPS = 900.0
#: No cited public list price: unpriced.
_UNPRICED = 0.0

_TABLE = (
    Topology("cpu-host", 1, 1.0, 40.0, 0.0, 0.0),
    Topology("h100-sxm-1", 1, **_H100_SXM, ici_gbps=0.0,
             usd_per_chip_hour=_UNPRICED),
    Topology("h100-sxm-4", 4, **_H100_SXM, ici_gbps=_NVLINK_GBPS,
             usd_per_chip_hour=_UNPRICED),
    Topology("h100-sxm-8", 8, **_H100_SXM, ici_gbps=_NVLINK_GBPS,
             usd_per_chip_hour=_UNPRICED),
)

TOPOLOGIES: dict[str, Topology] = {t.name: t for t in _TABLE}


def get_topology(name: str) -> Topology:
    """Table lookup (``cost_model_topology`` resolves through here)."""
    try:
        return TOPOLOGIES[name]
    except KeyError:
        raise ValueError(
            f"unknown topology {name!r}; known: "
            + ", ".join(sorted(TOPOLOGIES))
            + " (add entries in telemetry/topologies.py)"
        ) from None
