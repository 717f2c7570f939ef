"""Client data partitioning and packing (data/partition.py of the JAX
package, copied so the port imports nothing of it).

All client shards are packed into ONE fixed-shape array
``[n_clients, shard_size, ...]`` plus a 0/1 sample mask; per-client
``sizes`` drive the weighted aggregation. The packed arrays are
``np.array_equal`` to the JAX package's (tests/test_torch_data.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ClientData:
    """Packed per-client training shards (the client axis, materialized).

    Two storage layouts:
      * float32, sample shape preserved (``compact=False``);
      * uint8, samples flattened to ``[n_clients, shard_size, dim]``
        (``compact=True``, the simulator default) — a quarter of the
        float32 bytes in device memory. Batches are decoded (cast + /255 +
        reshape) on the fly inside the training step.
    """

    x: np.ndarray  # [n_clients, shard_size, ...] float32, or uint8 flat
    y: np.ndarray  # [n_clients, shard_size] int32
    mask: np.ndarray  # [n_clients, shard_size] float32; 0 = padding
    sizes: np.ndarray  # [n_clients] float32 = mask.sum(1); aggregation weights
    sample_shape: tuple = ()  # original per-sample shape when compact

    @property
    def n_clients(self) -> int:
        return self.x.shape[0]

    @property
    def shard_size(self) -> int:
        return self.x.shape[1]

    @property
    def compact(self) -> bool:
        return self.x.dtype == np.uint8

    def override_client(self, client_id: int, x: np.ndarray, y: np.ndarray):
        """Replace one client's shard (the heterogeneity injection of
        simulator_heterogeneous.py), truncated or padded to ``shard_size``;
        compact storage needs ``x`` in [0, 1]."""
        n = min(len(x), self.shard_size)
        xr = x[:n]
        if self.compact:
            ok, xmin, xmax = _unit_range(xr)
            if not ok:
                raise ValueError(
                    "override_client on a compact-packed ClientData requires "
                    f"data in [0, 1]; got range [{xmin:.4g}, {xmax:.4g}]. "
                    "Rescale the override, or pack with compact=False."
                )
            xr = _compact_encode(xr, n, self.x.shape[-1])
        self.x[client_id] = 0
        self.y[client_id] = 0
        self.mask[client_id] = 0.0
        self.x[client_id, :n] = xr
        self.y[client_id, :n] = y[:n]
        self.mask[client_id, :n] = 1.0
        self.sizes[client_id] = float(n)
        return self


def _compact_encode(x: np.ndarray, n: int, dim: int) -> np.ndarray:
    """uint8 flatten for compact storage; inverse is cast * (1/255) + reshape
    (parallel/engine.py make_decoder)."""
    return np.round(np.clip(x, 0.0, 1.0) * 255.0).astype(np.uint8).reshape(n, dim)


def _unit_range(x: np.ndarray) -> tuple[bool, float, float]:
    """Single source of truth for the compact-storage [0, 1] range contract.

    Returns (within_range, min, max); empty arrays are trivially in range
    (nothing to encode).
    """
    if x.size == 0:
        return True, 0.0, 0.0
    xmin, xmax = float(x.min()), float(x.max())
    return xmin >= -1e-6 and xmax <= 1.0 + 1e-6, xmin, xmax


def iid_partition(n_samples: int, n_clients: int, seed: int = 0) -> list[np.ndarray]:
    """Equal-size IID shards (reference simulator.py:48-50, weights [1]*N)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_samples)
    shard = n_samples // n_clients
    return [perm[i * shard : (i + 1) * shard] for i in range(n_clients)]


def dirichlet_partition(
    labels: np.ndarray, n_clients: int, alpha: float, seed: int = 0,
    min_size: int = 0,
) -> list[np.ndarray]:
    """Label-skewed non-IID split: per-class Dirichlet(alpha) over clients.

    Standard federated non-IID benchmark split (BASELINE.json configs[4]:
    "non-IID Dirichlet(alpha=0.1), 1000 clients"). Smaller alpha = more skew.
    Empty clients are legal (min_size=0, the default): the packed-shard mask
    gives them zero aggregation weight and zero gradient contribution, so
    extreme skew at high client counts "just works". Set ``min_size`` > 0 to
    re-draw until every client has that many samples (can be unsatisfiable
    for small alpha x large n_clients).
    """
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    for _ in range(100):
        client_indices: list[list[int]] = [[] for _ in range(n_clients)]
        for c in range(n_classes):
            idx = np.flatnonzero(labels == c)
            rng.shuffle(idx)
            props = rng.dirichlet([alpha] * n_clients)
            cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
            for client, part in enumerate(np.split(idx, cuts)):
                client_indices[client].extend(part.tolist())
        if min(len(ci) for ci in client_indices) >= min_size:
            return [
                np.array(sorted(ci), dtype=np.int64) for ci in client_indices
            ]
    raise RuntimeError(
        f"dirichlet_partition: could not satisfy min_size={min_size} "
        f"with alpha={alpha}, n_clients={n_clients}"
    )


def pack_client_shards(
    x: np.ndarray,
    y: np.ndarray,
    indices: list[np.ndarray],
    shard_size: int | None = None,
    batch_size: int | None = None,
    compact: bool = False,
) -> ClientData:
    """Pack per-client index lists into fixed-shape arrays + mask.

    ``shard_size`` defaults to the largest shard, rounded up to a multiple of
    ``batch_size`` (so every client's scan sees whole batches; padding rows
    carry mask 0 and contribute nothing to the loss). ``compact`` stores
    uint8-flattened samples (see :class:`ClientData`).
    """
    if compact:
        ok, xmin, xmax = _unit_range(x)
        if not ok:
            from distributed_learning_simulator_tpu_torch.utils.logging import (
                get_logger,
            )

            get_logger().warning(
                "compact uint8 client storage assumes inputs in [0, 1] but "
                "data range is [%.4g, %.4g]; falling back to float32 storage "
                "(set compact_client_data=False to silence)",
                xmin, xmax,
            )
            compact = False
    n_clients = len(indices)
    max_n = max(len(ix) for ix in indices)
    size = shard_size or max_n
    if batch_size:
        size = ((size + batch_size - 1) // batch_size) * batch_size
    sample_shape = x.shape[1:]
    if compact:
        dim = int(np.prod(sample_shape))
        cx = np.zeros((n_clients, size, dim), dtype=np.uint8)
    else:
        cx = np.zeros((n_clients, size) + sample_shape, dtype=x.dtype)
    cy = np.zeros((n_clients, size), dtype=np.int32)
    mask = np.zeros((n_clients, size), dtype=np.float32)
    for i, ix in enumerate(indices):
        n = min(len(ix), size)
        xi = x[ix[:n]]
        if compact:
            xi = _compact_encode(xi, n, dim)
        cx[i, :n] = xi
        cy[i, :n] = y[ix[:n]]
        mask[i, :n] = 1.0
    return ClientData(
        x=cx, y=cy, mask=mask, sizes=mask.sum(axis=1).astype(np.float32),
        sample_shape=tuple(sample_shape),
    )
