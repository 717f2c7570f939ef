"""Analytic communication-payload accounting (ops/payload.py and
utils/tree.py ``tree_bytes`` of the JAX package).

Nothing is serialized in a simulation, so a payload's size is defined from
the model's leaf shapes and dtype: bits per element times elements, plus
per-tensor metadata for quantized payloads. ``layout`` is the run's
models/registry.ParamLayout (anything with ``numels``).
"""

from __future__ import annotations

import torch


def tree_bytes(layout, dtype: torch.dtype = torch.float32,
               bits_per_element: int | None = None) -> int:
    """Every leaf at ``dtype``'s width, or at ``bits_per_element`` bits
    (rounded up to whole bytes over the whole payload)."""
    n = sum(layout.numels)
    if bits_per_element is None:
        return n * torch.empty((), dtype=dtype).element_size()
    return (n * bits_per_element + 7) // 8


def payload_bytes(layout, dtype: torch.dtype = torch.float32) -> int:
    """Uncompressed payload size."""
    return tree_bytes(layout, dtype)


def quantized_payload_bytes(layout, levels: int) -> int:
    """``ceil(log2(levels))`` bits per element plus 8 bytes (f32 scale and
    zero point) per tensor."""
    bits = max(1, (levels - 1).bit_length())
    return tree_bytes(layout, bits_per_element=bits) + 8 * len(layout.numels)


def sign_payload_bytes(layout) -> int:
    """1-bit-per-element sign payload (SignSGD uploads)."""
    return tree_bytes(layout, bits_per_element=1)


def compression_ratio(original_bytes: int, compressed_bytes: int) -> float:
    return original_bytes / max(1, compressed_bytes)
