"""SignSGD compression and majority vote (ops/sign.py of the JAX package).

Each client signs its effective update direction (1-bit compression), the
server sums the signs elementwise and re-signs (majority vote), and every
client applies the voted sign. The functions work on tensors of any shape;
the port applies them to flat parameter vectors.

Sign convention of ``torch.sign``: sign(0) = 0, and a tied vote gives 0 (no
update for that element).
"""

from __future__ import annotations

import numpy as np
import torch


def sign_compress(x: torch.Tensor) -> torch.Tensor:
    """Elementwise sign: the 1-bit client payload."""
    return torch.sign(x)


def majority_vote(stacked_signs: torch.Tensor) -> torch.Tensor:
    """``sign(sum(signs))`` over the leading (client) axis."""
    return torch.sign(stacked_signs.sum(dim=0))


def momentum_leaf(m, g, is_first, mu: float, dampening: float):
    """torch-SGD momentum buffer update: the first step sets the buffer to
    the raw gradient, later steps to ``mu*buf + (1-dampening)*grad``."""
    return torch.where(is_first, g, mu * m + (1.0 - dampening) * g)


def direction_leaf(g, m_new, mu: float, nesterov: bool):
    """Effective update direction after the momentum update: ``g +
    mu*buf`` under nesterov, else the buffer itself."""
    return g + mu * m_new if nesterov else m_new


def vote_apply_leaf(p, voted, lr: float, wd: float):
    """Apply the voted sign: weight decay + ``p - lr*sign``, i.e.
    ``p - lr * (voted + wd * p)``.

    XLA compiles that expression into two fused multiply-adds, each rounded
    once, so for f32 params the port computes each step in f64 (which holds
    the exact product of two f32 values) and rounds it to f32: the result
    equals the JAX round program's bit for bit."""
    if p.dtype != torch.float32:
        return p - lr * (voted + wd * p)
    lr32, wd32 = float(np.float32(lr)), float(np.float32(wd))
    p64 = p.double()
    inner = (voted.double() + wd32 * p64).float()
    return (p64 - lr32 * inner.double()).float()
